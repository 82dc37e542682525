"""CUDA kernel of forward flash attention: bind and launch.

The kernel (``csrc/flash_attention.cu``) replaces the JAX package's Pallas
TPU kernel ``_flash_kernel`` (``repro/kernels/flash_attention/
flash_attention.py``).  One block takes one (batch, head, 64-row query
tile) and walks the key tiles its rows can see with an fp32 online
softmax — see the note at the top of the source.

The source is compiled with ``nvcc`` at first use and bound with
``ctypes`` (``kernels/nvcc.py``); nothing is compiled at import time.

``LAUNCHES`` counts the kernel's launches: ``flash_attention_cuda`` adds
one right after each successful launch and nowhere else.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import nvcc

LAUNCHES = 0

SOURCE = nvcc.CSRC / "flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.arcadia_flash_attention.argtypes = [p, p, p, p, *[ll] * 12,
                                            i, i, i, i, i, i, i, f, f, i, p]
    lib.arcadia_flash_attention.restype = ctypes.c_int


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless the kernel takes q [B,H,S,D], k and v [B,KV,S,D] as
    they are: CUDA tensors of one dtype (fp32 or bf16), KV dividing H,
    D <= 256 and a multiple of 4, the head dim contiguous, and every
    stride and data pointer a multiple of four elements."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash kernel needs CUDA tensors, {name} is on "
                             f"{t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"flash kernel takes fp32 or bf16, {name} is "
                            f"{t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
        if t.stride(-1) != 1 or any(s % 4 for s in t.stride()[:3]) or \
                t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f"flash kernel needs {name} with a contiguous "
                             f"head dim and strides and data aligned to 4 "
                             f"elements, got strides {t.stride()}")
    B, H, S, D = q.shape
    KV = k.shape[1]
    if tuple(k.shape) != (B, KV, S, D) or v.shape != k.shape:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if KV < 1 or H % KV:
        raise ValueError(f"{KV} kv heads do not divide {H} heads")
    if D > MAX_HEAD_DIM or D % 4:
        raise ValueError(f"head dim {D}: the kernel takes multiples of 4 up "
                         f"to {MAX_HEAD_DIM}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: Optional[int] = None,
                         cap: Optional[float] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Attention of CUDA tensors in ONE kernel launch: the contract of
    ``ref.attention_reference`` (q [B,H,S,D]; k, v [B,KV,S,D] -> [B,H,S,D]
    in q's dtype, with q's strides)."""
    global LAUNCHES
    _check(q, k, v)
    B, H, S, D = q.shape
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    if cap is not None and not cap > 0:
        raise ValueError(f"softcap must be positive, got {cap}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)             # q's strides (it is dense)
    if out.numel() == 0:
        return out
    lib = nvcc.load(SOURCE, _bind)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.arcadia_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], B, H, k.shape[1], S, D, int(causal),
            0 if window is None else int(window), float(scale),
            0.0 if cap is None else float(cap), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash kernel launch failed: cudaError_t {err} "
                           f"(B={B}, H={H}, KV={k.shape[1]}, S={S}, D={D}, "
                           f"{q.dtype})")
    LAUNCHES += 1
    return out
