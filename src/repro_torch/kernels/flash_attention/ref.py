"""Plain PyTorch version of forward attention with causal / sliding-window
masks, a tanh logit softcap and GQA head grouping.

Materialised fp32 scores, as the JAX package's
``kernels/flash_attention/ref.py::attention_reference``: q [B,H,S,D];
k [B,KV,S,D] and v [B,KV,S,Dv] (Dv may differ from D, as MLA's prefill
has it), query head h reading kv head h // (H // KV); a key at
position t is seen by the query at position s when t <= s (causal) and
t > s - window (window).  Masked scores are set to NEG_INF = -2^30, the
softmax is taken in fp32, and p is cast to v's dtype before the PV
product.  This is what the CUDA kernel (``flash_attention.py``) is held
against, and what CPU tensors run.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -2.0 ** 30


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        cap: Optional[float] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q [B,H,S,D]; k [B,KV,S,D], v [B,KV,S,Dv] -> [B,H,S,Dv] in v's
    dtype."""
    B, H, S, D = q.shape
    rep = H // k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kk = k.repeat_interleave(rep, dim=1)
    vv = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhtd->bhqt", q.float(), kk.float()) * scale
    if cap is not None:
        s = torch.tanh(s / cap) * cap
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(S, device=q.device)[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= ki <= qi
    if window is not None:
        ok &= ki > qi - window
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqt,bhtd->bhqd", p, vv)
