"""CUDA kernel of the lane-polynomial integrity hash: build, bind, launch.

The kernel (``csrc/checksum.cu``) replaces the JAX package's Pallas TPU
kernel ``_checksum_kernel`` (``repro/kernels/checksum/checksum.py``).  It
hashes every row of a ``[rows, lanes]`` uint32 matrix in one launch, one
pass over the matrix, with each lane's weight r^i made in registers and
the per-block partials summed into ``out[row]`` with atomics — see the
note at the top of the source.  It is bound by HBM bytes.

The source is compiled with ``nvcc`` into a shared library with a plain
C interface at first use and bound with ``ctypes`` (``kernels/nvcc.py``).
Nothing is compiled at import time.

``LAUNCHES`` counts the kernel's launches: ``checksum_rows_cuda`` adds
one right after each successful launch and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from .. import nvcc
from .ref import MASK

LAUNCHES = 0

SOURCE = nvcc.CSRC / "checksum.cu"


def _bind(lib: ctypes.CDLL) -> None:
    lib.arcadia_checksum_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_void_p]
    lib.arcadia_checksum_rows.restype = ctypes.c_int


def checksum_rows_cuda(mat: torch.Tensor) -> torch.Tensor:
    """Row-wise hash of a CUDA ``[rows, lanes]`` int32/uint32 lane matrix
    in ONE kernel launch -> int64[rows] in [0, 2^32) on the same card."""
    global LAUNCHES
    if mat.device.type != "cuda":
        raise ValueError(f"checksum kernel needs a CUDA tensor, got {mat.device}")
    if mat.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"checksum kernel takes 32-bit lanes, got {mat.dtype}")
    if mat.dim() != 2:
        raise ValueError(f"expected a [rows, lanes] matrix, got {tuple(mat.shape)}")
    if not mat.is_contiguous():
        raise ValueError("checksum kernel needs a contiguous lane matrix")
    rows, lanes = mat.shape
    out = torch.zeros(rows, dtype=torch.int32, device=mat.device)
    if rows and lanes:
        lib = nvcc.load(SOURCE, _bind)
        with torch.cuda.device(mat.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.arcadia_checksum_rows(mat.data_ptr(), out.data_ptr(),
                                            rows, lanes, stream)
        if err != 0:
            raise RuntimeError(f"checksum kernel launch failed: cudaError_t {err} "
                               f"(rows={rows}, lanes={lanes})")
        LAUNCHES += 1
    return out.to(torch.int64) & MASK
