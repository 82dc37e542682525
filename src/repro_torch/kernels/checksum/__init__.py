"""Lane-polynomial integrity hash: plain version (``ref``), CUDA kernel
(``checksum``) and device routing (``ops``)."""
