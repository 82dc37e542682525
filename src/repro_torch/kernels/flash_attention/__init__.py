"""Forward flash attention: plain version (``ref``), CUDA kernel
(``flash_attention``) and device routing (``ops``)."""
