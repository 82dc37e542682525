"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``checksum`` (the lane-polynomial integrity hash), ``ssd_scan``
(the Mamba2 SSD chunked scan) and ``flash_attention`` (forward attention
with an online softmax), all built by ``nvcc``."""
