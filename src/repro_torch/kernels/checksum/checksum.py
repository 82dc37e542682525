"""CUDA kernels of the lane-polynomial integrity hash: build, bind, launch.

The kernels (``csrc/checksum.cu``) replace the JAX package's Pallas TPU
kernel ``_checksum_kernel`` (``repro/kernels/checksum/checksum.py``).
Each hashes every row of a ``[rows, lanes]`` uint32 matrix in one launch
and one pass over the matrix, with each lane's weight r^i made in
registers; both are bound by HBM bytes.  Two routes, chosen by the row
length (``route``):

* ``"short_rows"`` — rows of at most ``ROW_LANES`` lanes (the log's 1 KiB
  records): one warp a row, a shuffle sum, and lane 0 writes the int64
  value.  The launch is the whole hash: no memset, no atomics, no cast.
* ``"long_rows"`` — longer rows (1 MiB records, checkpoint shards, single
  tensors): a block per (row, 4096-lane chunk) and the per-block partials
  summed into ``out[row]`` with atomics, after a memset and before a cast
  to int64.

See the note at the top of the source.  The source is compiled with
``nvcc`` into a shared library with a plain C interface at first use and
bound with ``ctypes`` (``kernels/nvcc.py``).  Nothing is compiled at
import time.

``LAUNCHES`` counts the launches of both kernels, ``SHORT_ROW_LAUNCHES``
and ``LONG_ROW_LAUNCHES`` each route's: ``checksum_rows_cuda`` adds one to
``LAUNCHES`` and to its route's count right after each successful launch
and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from .. import nvcc
from .ref import MASK

LAUNCHES = 0
SHORT_ROW_LAUNCHES = 0
LONG_ROW_LAUNCHES = 0

SOURCE = nvcc.CSRC / "checksum.cu"
ROW_LANES = 4096                   # kRowLanes of the source

_fns: dict = {}


def _bind(lib: ctypes.CDLL) -> None:
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.arcadia_checksum_rows.argtypes = [p, p, ll, ll, p]
    lib.arcadia_checksum_rows.restype = ctypes.c_int
    lib.arcadia_checksum_short_rows.argtypes = [p, p, ll, ctypes.c_int, p]
    lib.arcadia_checksum_short_rows.restype = ctypes.c_int


def _fn(name: str):
    """The C function ``name`` of the built library, looked up once."""
    fn = _fns.get(name)
    if fn is None:
        fn = _fns[name] = getattr(nvcc.load(SOURCE, _bind), name)
    return fn


def route(lanes: int) -> str:
    """The kernel that hashes rows of ``lanes`` lanes."""
    return "short_rows" if lanes <= ROW_LANES else "long_rows"


def checksum_rows_cuda(mat: torch.Tensor) -> torch.Tensor:
    """Row-wise hash of a CUDA ``[rows, lanes]`` int32/uint32 lane matrix
    in ONE kernel launch -> int64[rows] in [0, 2^32) on the same card."""
    global LAUNCHES, SHORT_ROW_LAUNCHES, LONG_ROW_LAUNCHES
    if mat.device.type != "cuda":
        raise ValueError(f"checksum kernel needs a CUDA tensor, got {mat.device}")
    if mat.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"checksum kernel takes 32-bit lanes, got {mat.dtype}")
    if mat.dim() != 2:
        raise ValueError(f"expected a [rows, lanes] matrix, got {tuple(mat.shape)}")
    if not mat.is_contiguous():
        raise ValueError("checksum kernel needs a contiguous lane matrix")
    rows, lanes = mat.shape
    kind = route(lanes)
    short = kind == "short_rows"
    if rows == 0 or lanes == 0:
        return torch.zeros(rows, dtype=torch.int64, device=mat.device)
    with torch.cuda.device(mat.device):
        stream = torch.cuda.current_stream().cuda_stream
        if short:
            out = torch.empty(rows, dtype=torch.int64, device=mat.device)
            err = _fn("arcadia_checksum_short_rows")(
                mat.data_ptr(), out.data_ptr(), rows, lanes, stream)
        else:
            out = torch.zeros(rows, dtype=torch.int32, device=mat.device)
            err = _fn("arcadia_checksum_rows")(mat.data_ptr(), out.data_ptr(),
                                               rows, lanes, stream)
    if err != 0:
        raise RuntimeError(f"checksum kernel launch failed: cudaError_t {err} "
                           f"(rows={rows}, lanes={lanes}, {kind})")
    LAUNCHES += 1
    if short:
        SHORT_ROW_LAUNCHES += 1
        return out
    LONG_ROW_LAUNCHES += 1
    return out.to(torch.int64) & MASK
