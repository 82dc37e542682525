"""Routing of forward attention by the tensors' device.

CPU tensors go to the plain PyTorch version (``ref.py``), CUDA tensors to
the hand-written kernels (``flash_attention.py``: bf16 at the (D, Dv)
pairs (64, 64), (80, 80), (128, 128), (192, 128) and (256, 256) with
16-byte aligned views on the tensor cores, the rest on the CUDA cores),
anything else raises.  Nothing falls back: a CUDA tensor never reaches
the plain version, and a kernel that cannot build or launch, or an input
it does not take (a dtype other than fp32 or bf16, a head dim above 256,
a value head dim above q's, a head dim that is not contiguous), raises.
The kernels' launch count is ``flash_attention.LAUNCHES``, each route's
``TENSOR_CORE_LAUNCHES`` and ``CUDA_CORE_LAUNCHES``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .flash_attention import flash_attention_cuda


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    cap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q [B,H,S,D]; k [B,KV,S,D], v [B,KV,S,Dv] with Dv <= D ->
    [B,H,S,Dv]; query head h reads kv head h // (H // KV)."""
    kind = q.device.type
    if kind == "cpu":
        return ref.attention_reference(q, k, v, causal=causal, window=window,
                                       cap=cap, scale=scale)
    if kind == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    cap=cap, scale=scale)
    raise ValueError(f"no attention route for device {q.device}")
