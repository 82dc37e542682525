"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``checksum`` (the lane-polynomial integrity hash)."""
