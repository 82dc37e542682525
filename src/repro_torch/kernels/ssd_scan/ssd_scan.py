"""CUDA kernel of the Mamba2 SSD chunked scan: bind and launch.

The kernel (``csrc/ssd_scan.cu``) replaces the JAX package's Pallas TPU
kernel ``_ssd_kernel`` (``repro/kernels/ssd_scan/ssd_scan.py``).  One
block takes one (batch, head) and walks its chunks in order with the
running state in shared memory; the intra-chunk product is tiled 64 × 64
in the manner of flash attention — see the note at the top of the source.

The source is compiled with ``nvcc`` at first use and bound with
``ctypes`` (``kernels/nvcc.py``); nothing is compiled at import time.

``LAUNCHES`` counts the kernel's launches: ``ssd_cuda`` adds one right
after each successful launch and nowhere else.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import nvcc

LAUNCHES = 0

SOURCE = nvcc.CSRC / "ssd_scan.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.arcadia_ssd_scan.argtypes = [p, p, p, p, p, p, p,
                                     i, i, i, i, i, i, i, i, p]
    lib.arcadia_ssd_scan.restype = ctypes.c_int


def _check(xh, dt, A_log, Bm, Cm, chunk: int) -> int:
    if xh.device.type != "cuda":
        raise ValueError(f"SSD kernel needs CUDA tensors, got {xh.device}")
    for name, t in (("dt", dt), ("A_log", A_log), ("Bm", Bm), ("Cm", Cm)):
        if t.device != xh.device:
            raise ValueError(f"{name} is on {t.device}, xh on {xh.device}")
        if not t.is_contiguous():
            raise ValueError(f"SSD kernel needs a contiguous {name}")
    if not xh.is_contiguous():
        raise ValueError("SSD kernel needs a contiguous xh")
    if xh.dtype not in _DTYPES:
        raise TypeError(f"SSD kernel takes fp32 or bf16 xh, got {xh.dtype}")
    if Bm.dtype != xh.dtype or Cm.dtype != xh.dtype:
        raise TypeError(f"Bm/Cm ({Bm.dtype}, {Cm.dtype}) must match xh "
                        f"({xh.dtype})")
    if dt.dtype != torch.float32 or A_log.dtype != torch.float32:
        raise TypeError(f"dt and A_log must be fp32, got {dt.dtype}, "
                        f"{A_log.dtype}")
    if xh.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"expected xh [B,S,H,P] and Bm [B,S,G,N], got "
                         f"{tuple(xh.shape)}, {tuple(Bm.shape)}")
    B_, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if tuple(dt.shape) != (B_, S, H) or tuple(A_log.shape) != (H,) or \
            tuple(Bm.shape[:2]) != (B_, S) or Cm.shape != Bm.shape:
        raise ValueError(f"SSD shapes disagree: xh {tuple(xh.shape)}, dt "
                         f"{tuple(dt.shape)}, A_log {tuple(A_log.shape)}, "
                         f"Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    Q = min(chunk, S)
    if Q < 1 or S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    if H % G:
        raise ValueError(f"{G} groups do not divide {H} heads")
    return Q


def ssd_cuda(xh: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan of CUDA tensors in ONE kernel launch: the contract of
    ``ref.ssd_reference`` -> (y [B,S,H,P] in xh's dtype, state [B,H,P,N]
    fp32)."""
    global LAUNCHES
    Q = _check(xh, dt, A_log, Bm, Cm, chunk)
    B_, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    y = torch.empty_like(xh)
    state = torch.empty((B_, H, P, N), dtype=torch.float32, device=xh.device)
    if y.numel() == 0:
        return y, state.zero_()
    lib = nvcc.load(SOURCE, _bind)
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.arcadia_ssd_scan(
            xh.data_ptr(), dt.data_ptr(), A_log.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
            B_, S, H, P, G, N, Q, _DTYPES[xh.dtype], stream)
    if err != 0:
        raise RuntimeError(f"SSD kernel launch failed: cudaError_t {err} "
                           f"(B={B_}, S={S}, H={H}, P={P}, G={G}, N={N}, "
                           f"Q={Q}, {xh.dtype})")
    LAUNCHES += 1
    return y, state
