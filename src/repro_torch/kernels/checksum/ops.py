"""Routing of the tensor integrity hash by the tensor's device.

A CPU tensor goes to the plain PyTorch version (``ref.py``), a CUDA
tensor to the hand-written kernel (``checksum.py``), anything else
raises.  Nothing falls back: a CUDA tensor never reaches the plain
version, and a kernel that cannot build or launch raises.  Both routes
are integer-identical (tests assert ==, it is an integer hash).

The kernel's launch count is ``checksum.LAUNCHES``.
"""

from __future__ import annotations

import torch

from . import ref
from .checksum import checksum_rows_cuda


def _route(t: torch.Tensor) -> str:
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no integrity-hash route for device {t.device}")
    return kind


def tensor_checksum(x: torch.Tensor) -> torch.Tensor:
    """Hash of one tensor (any shape and dtype) -> int64 scalar in
    [0, 2^32), on ``x``'s device."""
    if _route(x) == "cpu":
        return ref.tensor_checksum(x)
    return checksum_rows_cuda(ref.as_words(x).view(1, -1))[0]


def tensor_checksum_batch(mat: torch.Tensor) -> torch.Tensor:
    """Row-wise hash of a ``[rows, lanes]`` uint32/int32 lane matrix ->
    int64[rows] in [0, 2^32).

    Rows are zero-padded to the common lane count; trailing zero lanes
    contribute nothing to the polynomial, so each row's value equals
    ``tensor_checksum`` of its unpadded bytes.  On the card the whole
    matrix is hashed in one kernel launch."""
    if mat.dim() != 2:
        raise ValueError(f"expected a [rows, lanes] matrix, got {tuple(mat.shape)}")
    if _route(mat) == "cpu":
        return ref.checksum_lanes_2d(mat)
    return checksum_rows_cuda(mat.contiguous())
