"""Arcadia, the persistent-memory replicated log, in PyTorch and CUDA.

The port of the JAX package ``repro``: the log's append → force →
recover path (``repro_torch.core``) with its integrity hash as a
hand-written CUDA kernel for Hopper (``repro_torch.kernels.checksum``).
"""
