"""Flash attention and its gradient: plain versions (``ref``), CUDA
kernels (``flash_attention``) and device routing (``ops``)."""
