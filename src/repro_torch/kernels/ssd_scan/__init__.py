"""Mamba2 SSD chunked scan: plain version (``ref``), CUDA kernel
(``ssd_scan``) and device routing (``ops``)."""
