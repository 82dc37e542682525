"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``checksum`` (the lane-polynomial integrity hash) and
``ssd_scan`` (the Mamba2 SSD chunked scan), both built by ``nvcc``."""
