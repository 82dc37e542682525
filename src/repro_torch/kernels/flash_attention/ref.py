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

``attention_split_reference``, ``attention_lse_split_reference`` and
``attention_backward_split_reference`` mirror the fp32 arithmetic of the
mma.sync kernels (the ``"cuda_cores"`` route): each product a·b taken as
three TF32 products aₗ·bₕ + aₕ·bₗ + aₕ·bₕ, hi = tf32(x) and lo = tf32(x -
hi), tf32() rounding to nearest with ties away from zero as
``cvt.rna.tf32.f32`` does — all but the backward's dP = dO·Vᵀ, which that
kernel takes in fp32; ``products=1`` is the single TF32 product the
kernels do not use, which the checks must tell apart.
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


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 mantissa bits) as ``cvt.rna.tf32.f32``
    rounds it: to nearest, ties away from zero, on the bits — 0x1000 added
    to the int32 view, the low 13 bits cleared."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32 rounding takes fp32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(hi, lo) = (tf32(x), tf32(x - hi)): x to about 22 of its 24 bits."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def split_einsum(eq: str, a: torch.Tensor, b: torch.Tensor,
                 products: int = 3) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` of fp32 operands as the mma.sync kernels
    take it: three TF32 products aₗ·bₕ + aₕ·bₗ + aₕ·bₕ with fp32 sums
    (``products=3``), or the one product tf32(a)·tf32(b) (``products=1``).
    Each TF32 product is exact in fp32; only the sums round."""
    if products == 1:
        return torch.einsum(eq, tf32_round(a), tf32_round(b))
    if products != 3:
        raise ValueError(f"products must be 1 or 3, got {products}")
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + \
        torch.einsum(eq, ah, bh)


def _split_mm(q: torch.Tensor, products: int):
    if q.dtype != torch.float32:
        raise TypeError(f"the split mirrors fp32 inputs, got {q.dtype}")
    return lambda eq, a, b: split_einsum(eq, a, b, products)


def _capped_scores(q, k, cap, scale, mm=torch.einsum):
    """Scores [B,H,S,S] of q against k repeated over each group, scaled and
    capped (unmasked), in the accumulation type; ``mm`` takes the
    product."""
    rep = q.shape[1] // k.shape[1]
    kk = k.repeat_interleave(rep, dim=1)
    s = mm("bhqd,bhtd->bhqt", q.to(_acc(q)), kk.to(_acc(q))) * scale
    if cap is not None:
        s = torch.tanh(s / cap) * cap
    return s


def _masked_scores(q, k, causal, window, cap, scale, mm=torch.einsum):
    ok = _visible(q.shape[2], causal, window, q.device)
    return torch.where(ok, _capped_scores(q, k, cap, scale, mm), NEG_INF)


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


def attention_split_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: Optional[int] = None,
                              cap: Optional[float] = None,
                              scale: Optional[float] = None,
                              products: int = 3) -> torch.Tensor:
    """``attention_reference`` of fp32 inputs with Q·Kᵀ and P·V taken as
    the mma.sync kernel takes them (``split_einsum``)."""
    mm = _split_mm(q, products)
    rep = q.shape[1] // k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    p = torch.softmax(_masked_scores(q, k, causal, window, cap, scale, mm),
                      dim=-1)
    return mm("bhqt,bhtd->bhqd", p, v.repeat_interleave(rep, dim=1))


def attention_lse_split_reference(q: torch.Tensor, k: torch.Tensor, *,
                                  causal: bool = True,
                                  window: Optional[int] = None,
                                  cap: Optional[float] = None,
                                  scale: Optional[float] = None,
                                  products: int = 3) -> torch.Tensor:
    """``attention_lse_reference`` with the split Q·Kᵀ."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return torch.logsumexp(_masked_scores(q, k, causal, window, cap, scale,
                                          _split_mm(q, products)), dim=-1)


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


def attention_backward_split_reference(q: torch.Tensor, k: torch.Tensor,
                                       v: torch.Tensor, o: torch.Tensor,
                                       lse: torch.Tensor, do: torch.Tensor, *,
                                       causal: bool = True,
                                       window: Optional[int] = None,
                                       cap: Optional[float] = None,
                                       scale: Optional[float] = None,
                                       fault: Optional[str] = None,
                                       products: int = 3):
    """``attention_backward_reference`` of fp32 inputs with S, dq, dk and
    dv taken as the mma.sync backward takes them (``split_einsum``) and dP
    = dO·Vᵀ in fp32, as that kernel takes it on the CUDA cores (dq's row at
    a query that sees few keys is dS = p·(dP - delta), a cancellation the
    TF32 split and the tensor cores' truncating sums missed the fp32 row
    check on): the CPU mirror of ``csrc/flash_attention_bwd.cu`` in fp32."""
    return _backward(q, k, v, o, lse, do, causal, window, cap, scale, fault,
                     round_ds=False, mm=_split_mm(q, products))


def _backward(q, k, v, o, lse, do, causal, window, cap, scale, fault,
              round_ds: bool, mm=torch.einsum):
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    B, H, S, D = q.shape
    KV, Dv = k.shape[1], v.shape[-1]
    G = H // KV
    acc = _acc(q)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    ok = _visible(S, causal, None if fault == "no_window" else window,
                  q.device)
    s = _capped_scores(q, k, cap, scale, mm)
    p = torch.where(ok, torch.exp(s - lse.to(acc)[..., None]), 0.0)
    dof = do.to(acc)
    vv = v.repeat_interleave(G, dim=1).to(acc)
    kk = k.repeat_interleave(G, dim=1).to(acc)
    delta = (dof * o.to(acc)).sum(-1, keepdim=True)
    if fault == "no_delta":
        delta = torch.zeros_like(delta)
    # dP in the accumulation type in every version: the split's kernel
    # takes it in fp32 FMAs
    ds = p * (torch.einsum("bhqd,bhtd->bhqt", dof, vv) - delta)
    if cap is not None and fault != "no_cap_grad":
        ds = ds * (1.0 - (s / cap) ** 2)
    if round_ds:
        ds = ds.to(q.dtype).to(acc)
    dq = scale * mm("bhqt,bhtd->bhqd", ds, kk)
    dk = scale * mm("bhqt,bhqd->bhtd", ds, q.to(acc))
    dv = mm("bhqt,bhqd->bhtd", p.to(v.dtype).to(acc), dof)
    dk, dv = dk.view(B, KV, G, S, D), dv.view(B, KV, G, S, Dv)
    if fault == "one_head":
        dk, dv = dk[:, :, 0], dv[:, :, 0]
    else:
        dk, dv = dk.sum(2), dv.sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
