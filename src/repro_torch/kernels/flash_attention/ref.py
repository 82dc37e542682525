"""Plain PyTorch versions of attention with causal / sliding-window masks,
a tanh logit softcap and GQA head grouping: the forward, its per-row
log-sum-exp and its backward.

Materialised scores, as the JAX package's
``kernels/flash_attention/ref.py::attention_reference``: q [B,H,S,D];
k [B,KV,S,D] and v [B,KV,S,Dv] (Dv may differ from D, as MLA's prefill
has it), query head h reading kv head h // (H // KV); a key at
position t is seen by the query at position s when t <= s (causal) and
t > s - window (window).  Masked scores are set to NEG_INF = -2^30, the
softmax is taken in fp32 (fp64 for fp64 inputs), and p is cast to v's
dtype before the PV product.  These are what the CUDA kernels
(``flash_attention.py``) are held against, and what CPU tensors run.

``attention_backward_reference`` is the backward written out, not
autograd: from the forward's output o and lse it recomputes
p = exp(s - lse), delta = rowsum(dO ∘ O), dP = dO·Vᵀ,
dS = p ∘ (dP - delta) ∘ (1 - (s_capped/cap)²) (the last factor with a
softcap), dq = scale·dS·K, dk = scale·dSᵀ·Q and dv = bf(p)ᵀ·dO, dk and dv
summed over each kv head's G query heads in head order; bf() rounds p to
v's dtype where it meets dO, as the kernels do.  Its ``fault`` argument
plants one of four wrong backwards the checks must tell apart.
``attention_backward_tc_reference`` is the same with the one rounding the
tensor-core backward adds: dS rounded to q's dtype where it meets K (dq)
and Q (dk), as that kernel's products take bf16 operands.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -2.0 ** 30

# planted faults of the backward: the softcap's derivative dropped, dk and
# dv from the group's first head only, delta left out, the window ignored
FAULTS = ("no_cap_grad", "one_head", "no_delta", "no_window")


def _acc(q: torch.Tensor) -> torch.dtype:
    """The type the scores are taken in: fp64 for fp64 inputs, else fp32."""
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def _visible(S: int, causal: bool, window: Optional[int], device
             ) -> torch.Tensor:
    """[S, S] bool: the query at row s sees the key at column t."""
    qi = torch.arange(S, device=device)[:, None]
    ki = torch.arange(S, device=device)[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        ok &= ki <= qi
    if window is not None:
        ok &= ki > qi - window
    return ok


def _capped_scores(q, k, cap, scale):
    """Scores [B,H,S,S] of q against k repeated over each group, scaled and
    capped (unmasked), in the accumulation type."""
    rep = q.shape[1] // k.shape[1]
    kk = k.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhtd->bhqt", q.to(_acc(q)), kk.to(_acc(q))) * scale
    if cap is not None:
        s = torch.tanh(s / cap) * cap
    return s


def _masked_scores(q, k, causal, window, cap, scale):
    ok = _visible(q.shape[2], causal, window, q.device)
    return torch.where(ok, _capped_scores(q, k, cap, scale), NEG_INF)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        cap: Optional[float] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q [B,H,S,D]; k [B,KV,S,D], v [B,KV,S,Dv] -> [B,H,S,Dv] in v's
    dtype."""
    rep = q.shape[1] // k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = _masked_scores(q, k, causal, window, cap, scale)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqt,bhtd->bhqd", p, v.repeat_interleave(rep, dim=1))


def attention_lse_reference(q: torch.Tensor, k: torch.Tensor, *,
                            causal: bool = True, window: Optional[int] = None,
                            cap: Optional[float] = None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Each row's log-sum-exp of its scaled, capped and masked scores ->
    [B,H,S] in fp32 (fp64 for fp64 inputs): the forward kernels' ``lse``
    output."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return torch.logsumexp(_masked_scores(q, k, causal, window, cap, scale),
                           dim=-1)


def attention_backward_reference(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, o: torch.Tensor,
                                 lse: torch.Tensor, do: torch.Tensor, *,
                                 causal: bool = True,
                                 window: Optional[int] = None,
                                 cap: Optional[float] = None,
                                 scale: Optional[float] = None,
                                 fault: Optional[str] = None):
    """(dq, dk, dv) of ``attention_reference`` at (q, k, v), given its
    output o [B,H,S,Dv], its ``lse`` [B,H,S] and the cotangent ``do`` of
    o, each gradient in its input's dtype (see the module note)."""
    return _backward(q, k, v, o, lse, do, causal, window, cap, scale, fault,
                     round_ds=False)


def attention_backward_tc_reference(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, o: torch.Tensor,
                                    lse: torch.Tensor, do: torch.Tensor, *,
                                    causal: bool = True,
                                    window: Optional[int] = None,
                                    cap: Optional[float] = None,
                                    scale: Optional[float] = None,
                                    fault: Optional[str] = None):
    """``attention_backward_reference`` with dS rounded to q's dtype
    before dq = scale·dS·K and dk = scale·dSᵀ·Q: the CPU mirror of the
    tensor-core backward (``csrc/flash_attention_bwd_tc.cu``)."""
    return _backward(q, k, v, o, lse, do, causal, window, cap, scale, fault,
                     round_ds=True)


def _backward(q, k, v, o, lse, do, causal, window, cap, scale, fault,
              round_ds: bool):
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    B, H, S, D = q.shape
    KV, Dv = k.shape[1], v.shape[-1]
    G = H // KV
    acc = _acc(q)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    ok = _visible(S, causal, None if fault == "no_window" else window,
                  q.device)
    s = _capped_scores(q, k, cap, scale)
    p = torch.where(ok, torch.exp(s - lse.to(acc)[..., None]), 0.0)
    dof = do.to(acc)
    vv = v.repeat_interleave(G, dim=1).to(acc)
    kk = k.repeat_interleave(G, dim=1).to(acc)
    delta = (dof * o.to(acc)).sum(-1, keepdim=True)
    if fault == "no_delta":
        delta = torch.zeros_like(delta)
    ds = p * (torch.einsum("bhqd,bhtd->bhqt", dof, vv) - delta)
    if cap is not None and fault != "no_cap_grad":
        ds = ds * (1.0 - (s / cap) ** 2)
    if round_ds:
        ds = ds.to(q.dtype).to(acc)
    dq = scale * torch.einsum("bhqt,bhtd->bhqd", ds, kk)
    dk = scale * torch.einsum("bhqt,bhqd->bhtd", ds, q.to(acc))
    dv = torch.einsum("bhqt,bhqd->bhtd", p.to(v.dtype).to(acc), dof)
    dk, dv = dk.view(B, KV, G, S, D), dv.view(B, KV, G, S, Dv)
    if fault == "one_head":
        dk, dv = dk[:, :, 0], dv[:, :, 0]
    else:
        dk, dv = dk.sum(2), dv.sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
