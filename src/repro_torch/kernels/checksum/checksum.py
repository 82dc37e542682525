"""CUDA kernel of the lane-polynomial integrity hash: build, bind, launch.

The kernel (``csrc/checksum.cu``) replaces the JAX package's Pallas TPU
kernel ``_checksum_kernel`` (``repro/kernels/checksum/checksum.py``).  It
hashes every row of a ``[rows, lanes]`` uint32 matrix in one launch, one
pass over the matrix, with each lane's weight r^i made in registers and
the per-block partials summed into ``out[row]`` with atomics — see the
note at the top of the source.  It is bound by HBM bytes.

The source is compiled with ``nvcc`` into a shared library with a plain
C interface at first use, into ``_build/`` beside the package's sources
(the library's name carries a hash of the source, so an edited kernel is
rebuilt), and bound with ``ctypes``.  Nothing is compiled at import time.

``LAUNCHES`` counts the kernel's launches: ``checksum_rows_cuda`` adds
one right after each successful launch and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

from .ref import MASK

LAUNCHES = 0

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "checksum.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the checksum kernel cannot be built")


def build() -> Path:
    """Compile ``csrc/checksum.cu`` unless a library of the same source is
    already built; returns the library's path."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libarcadia_checksum-{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)                 # atomic: concurrent builders agree
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.arcadia_checksum_rows.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_void_p]
            lib.arcadia_checksum_rows.restype = ctypes.c_int
            _lib = lib
        return _lib


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
        lib = _load()
        with torch.cuda.device(mat.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.arcadia_checksum_rows(mat.data_ptr(), out.data_ptr(),
                                            rows, lanes, stream)
        if err != 0:
            raise RuntimeError(f"checksum kernel launch failed: cudaError_t {err} "
                               f"(rows={rows}, lanes={lanes})")
        LAUNCHES += 1
    return out.to(torch.int64) & MASK
