"""Neural layers of the port, in PyTorch: the numerics helpers, rotary
embeddings, the attention strategies, the GQA and MLA attention layers,
the dense MLP, the mixture of experts and the Mamba2 (SSD) mixer of the
JAX package's ``models/layers.py``.

Two kernels sit under these layers.  The mixer's chunked scan goes
through ``kernels/ssd_scan/ops.ssd``; the prefill attention of a CUDA
tensor goes through ``kernels/flash_attention/ops.flash_attention``.
Each routes a CUDA tensor to its hand-written kernel and a CPU tensor to
its plain version, and each has a hand-written backward kernel on the
card.  On the CPU, ``attention`` picks the JAX package's
strategy by shape (direct, blockwise or sliding), so that each strategy
can be held against its counterpart.  Decode attention (one query
against the cache) is the plain direct path on both devices, as in the
JAX package (MLA's absorbed decode attends in its latent space there).
The MoE layer's expert products are batched matmuls, as the JAX package
leaves them to XLA; with ``set_moe_ep`` its dispatch runs expert-parallel,
as two all-to-alls over a process group (NCCL on the card, gloo on the
CPU).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..kernels.causal_conv.ops import causal_conv as _causal_conv
from ..kernels.flash_attention import ops as flash_ops
from ..kernels.ssd_scan import ops as ssd_ops
from .config import ModelConfig

NEG_INF = -2.0 ** 30


@dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a tensor not yet allocated (the port's
    ``jax.ShapeDtypeStruct``; a leaf of a tree)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def torch_dtype(name) -> torch.dtype:
    """"float32" / "bfloat16" / a torch dtype -> the torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# ---------------------------------------------------------------------- #
# numerics helpers
# ---------------------------------------------------------------------- #

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm in fp32 with a ``1 + w`` gain (zero-initialised w), cast
    back to x's dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x), as ``jax.nn.softplus`` computes it (no threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in the promoted dtype of the two, as a JAX einsum of mixed
    dtypes computes (a bf16 weight against an fp32 residual is fp32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


def rope_tables(positions: torch.Tensor, dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [..., S] -> cos/sin tables [..., S, dim/2] (fp32)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x [..., S, H, D]; cos/sin [..., S, D/2] broadcast over heads.  The
    two halves of the head dim rotate together (not interleaved pairs),
    in fp32."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------- #
# attention strategies
# ---------------------------------------------------------------------- #

def _mask_bias(qi: torch.Tensor, ki: torch.Tensor, causal: bool,
               window: Optional[int], kv_len: Optional[int]) -> torch.Tensor:
    """Additive fp32 bias [q, k] from absolute indices: 0 where the key is
    seen, NEG_INF where it is masked."""
    ok = torch.ones((qi.shape[-1], ki.shape[-1]), dtype=torch.bool,
                    device=qi.device)
    if causal:
        ok &= ki[None, :] <= qi[:, None]
    if window is not None:
        ok &= ki[None, :] > qi[:, None] - window
    if kv_len is not None:
        ok &= ki[None, :] < kv_len
    return torch.where(ok, 0.0, NEG_INF).float()


def _scores(q, k, scale, cap):
    """fp32 scores [B,K,G,q,t] of q [B,q,K,G,D] against k [B,t,K,D]: the
    products of the inputs summed in fp32, as the JAX package's
    ``preferred_element_type=float32``."""
    s = torch.einsum("bqkgd,btkd->bkgqt", q.float(), k.float()) * scale
    return softcap(s, cap)


def _direct_attention(q, k, v, *, scale, causal, window, cap, q_offset,
                      kv_len):
    """q [B,Sq,K,G,D]; k,v [B,Sk,K,D] -> [B,Sq,K,G,D] (materialised
    scores: short sequences and decode)."""
    Sq, Sk = q.shape[1], k.shape[1]
    s = _scores(q, k, scale, cap)
    qi = q_offset + torch.arange(Sq, device=q.device)
    ki = torch.arange(Sk, device=q.device)
    s = s + _mask_bias(qi, ki, causal, window, kv_len)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bkgqt,btkd->bqkgd", p, v)


def _blockwise_attention(q, k, v, *, scale, causal, window, cap, q_offset,
                         chunk_q):
    """q-chunked attention against the full K/V (memory O(chunk_q × Sk)):
    long global prefill on the CPU."""
    Sq = q.shape[1]
    kpos = torch.arange(k.shape[1], device=q.device)
    outs = []
    for start in range(0, Sq, chunk_q):
        s = _scores(q[:, start:start + chunk_q], k, scale, cap)
        qpos = q_offset + start + torch.arange(chunk_q, device=q.device)
        s = s + _mask_bias(qpos, kpos, causal, window, None)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bkgqt,btkd->bqkgd", p, v))
    return torch.cat(outs, dim=1).to(q.dtype)


def _sliding_attention(q, k, v, *, scale, window, cap, chunk_q):
    """Banded local attention: each query chunk sees only the keys in
    [start - window, start + chunk_q) — O(S·w) instead of O(S²), gemma2's
    local layers on the CPU.  Causal by construction."""
    Sq = q.shape[1]
    band = window + chunk_q               # kv slab per query chunk
    # left-pad K/V so that every slab read is in bounds
    kp = F.pad(k, (0, 0, 0, 0, window, 0))
    vp = F.pad(v, (0, 0, 0, 0, window, 0))
    outs = []
    for start in range(0, Sq, chunk_q):
        s = _scores(q[:, start:start + chunk_q], kp[:, start:start + band],
                    scale, cap)
        qpos = start + torch.arange(chunk_q, device=q.device)
        kpos = start - window + torch.arange(band, device=q.device)
        ok = (kpos[None, :] <= qpos[:, None]) & \
            (kpos[None, :] > qpos[:, None] - window) & (kpos[None, :] >= 0)
        s = s + torch.where(ok, 0.0, NEG_INF).float()
        p = torch.softmax(s, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bkgqt,btkd->bqkgd", p,
                                 vp[:, start:start + band]))
    return torch.cat(outs, dim=1).to(q.dtype)


def _flash_attention(q, k, v, *, scale, causal, window, cap):
    """Prefill through ``kernels/flash_attention``: q [B,S,K,G,D] read as
    [B,H,S,D] with H = K·G (query head k·G + g reads kv head k, the
    kernel's h // G), k [B,K,S,D] and v [B,K,S,Dv] — permuted views, no
    copy.  Returns [B,S,K,G,Dv]."""
    B, S, K, G, D = q.shape
    o = flash_ops.flash_attention(
        q.reshape(B, S, K * G, D).transpose(1, 2), k.transpose(1, 2),
        v.transpose(1, 2), causal=causal, window=window, cap=cap,
        scale=scale)
    return o.transpose(1, 2).reshape(B, S, K, G, v.shape[-1])


def attention(q, k, v, *, causal=True, window=None, cap=None, q_offset=0,
              kv_len=None, chunk_q=512, scale=None):
    """q [B,Sq,K,G,D]; k [B,Sk,K,D], v [B,Sk,K,Dv] -> [B,Sq,K,G,Dv].

    A prefill of CUDA tensors (Sq == Sk, no ``kv_len``, no offset) goes to
    the flash kernel, whatever the shape; where it needs a gradient
    (training) it goes through ``flash_ops``' autograd Function, whose
    forward also writes each row's log-sum-exp and whose backward is the
    flash backward kernel.  Everything else chooses as the JAX package
    does: decode or short -> direct; long local -> sliding; long global
    -> q-chunked lazy softmax.  CPU prefill keeps these strategies rather
    than the plain version behind ``flash_ops`` so that the CPU parity
    tests hold each of them to its JAX counterpart, and CPU training
    differentiates through them with autograd, as the JAX package does
    with ``jax.grad``."""
    B, Sq, K, G, D = q.shape
    Sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if q.device.type == "cuda" and Sq == Sk and kv_len is None and \
            q_offset == 0:
        return _flash_attention(q, k, v, scale=scale, causal=causal,
                                window=window, cap=cap)
    if Sq == 1 or Sq * Sk <= 2048 * 2048 or kv_len is not None:
        return _direct_attention(q, k, v, scale=scale, causal=causal,
                                 window=window, cap=cap, q_offset=q_offset,
                                 kv_len=kv_len)
    if window is not None and Sq % chunk_q == 0 and Sq > window:
        return _sliding_attention(q, k, v, scale=scale, window=window,
                                  cap=cap, chunk_q=chunk_q)
    if Sq % chunk_q == 0:
        return _blockwise_attention(q, k, v, scale=scale, causal=causal,
                                    window=window, cap=cap,
                                    q_offset=q_offset, chunk_q=chunk_q)
    return _direct_attention(q, k, v, scale=scale, causal=causal,
                             window=window, cap=cap, q_offset=q_offset,
                             kv_len=kv_len)


# ---------------------------------------------------------------------- #
# GQA attention layer and the dense MLP
# ---------------------------------------------------------------------- #

def gqa_params_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    shapes = {
        "wq": (D, KV, H // KV, hd),
        "wk": (D, KV, hd),
        "wv": (D, KV, hd),
        "wo": (KV, H // KV, hd, D),
    }
    if cfg.qkv_bias:
        shapes.update({"bq": (KV, H // KV, hd), "bk": (KV, hd),
                       "bv": (KV, hd)})
    return shapes


def gqa_attention(x, p, cfg: ModelConfig, *, local: bool,
                  cache: Optional[Dict[str, torch.Tensor]] = None,
                  index: Optional[int] = None):
    """x [B,S,D].  cache = {"k","v" [B,T,KV,hd]} for serving; ``index`` is
    the global write position (0 at prefill).  Returns (y, new_cache).

    Unlike the JAX package, which returns updated copies, the port writes
    the new keys and values into ``cache`` in place and returns the same
    tensors: at gemma2-9b's width the cache is 5.6 GB, and a copy per
    layer and step would move it all every decode step."""
    B, S, D = x.shape
    hd = cfg.resolved_head_dim
    K, G = p["wq"].shape[1], p["wq"].shape[2]
    q = _mm(x, p["wq"].reshape(D, K * G * hd)).view(B, S, K, G, hd)
    k = _mm(x, p["wk"].reshape(D, K * hd)).view(B, S, K, hd)
    v = _mm(x, p["wv"].reshape(D, K * hd)).view(B, S, K, hd)
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    pos0 = 0 if index is None else int(index)
    positions = (pos0 + torch.arange(S, device=x.device))[None, :]
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)
    q = apply_rope(q.reshape(B, S, K * G, hd), cos, sin).reshape(q.shape)
    k = apply_rope(k, cos, sin)
    window = cfg.sliding_window if local else None
    cap = cfg.attn_logit_softcap
    if cache is None:
        o = attention(q, k, v, causal=cfg.causal, window=window, cap=cap)
        new_cache = None
    else:
        ck, cv = cache["k"], cache["v"]
        ck[:, pos0:pos0 + S] = k.to(ck.dtype)
        cv[:, pos0:pos0 + S] = v.to(cv.dtype)
        if S > 1:
            # prefill (index 0 by construction): attend within the new
            # span, skipping the still-empty tail of the cache
            o = attention(q, k, v, causal=cfg.causal, window=window, cap=cap)
        else:
            o = attention(q, ck, cv, causal=False, window=window, cap=cap,
                          q_offset=pos0, kv_len=pos0 + S)
        new_cache = {"k": ck, "v": cv}
    y = _mm(o.reshape(B, S, K * G * hd), p["wo"].reshape(K * G * hd, D))
    return y, new_cache


def gqa_cache_spec(cfg: ModelConfig, batch: int, max_len: int
                   ) -> Dict[str, TensorSpec]:
    dt = torch_dtype(cfg.compute_dtype)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": TensorSpec(shape, dt), "v": TensorSpec(shape, dt)}


def mlp_params_shapes(cfg: ModelConfig, d_ff: int) -> Dict[str, Tuple]:
    D = cfg.d_model
    n_in = 2 if cfg.gated_mlp else 1
    shapes = {"wi": (D, n_in, d_ff), "wo": (d_ff, D)}
    if cfg.mlp_bias:
        shapes.update({"bi": (n_in, d_ff), "bo": (D,)})
    return shapes


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The activation in fp32.  gelu is the tanh approximation:
    ``jax.nn.gelu`` defaults to it, torch's ``gelu`` to the exact erf."""
    if kind == "gelu":
        return F.gelu(x.float(), approximate="tanh")
    return F.silu(x.float())


def mlp(x, p, cfg: ModelConfig):
    """Dense FFN: gated (act(gate) · up) or 2-matrix, optional biases."""
    D = x.shape[-1]
    n_in, d_ff = p["wi"].shape[1], p["wi"].shape[2]
    h = _mm(x, p["wi"].reshape(D, n_in * d_ff)).view(*x.shape[:-1], n_in,
                                                     d_ff)
    if cfg.mlp_bias:
        h = h + p["bi"]
    if cfg.gated_mlp:
        act = _act(h[..., 0, :], cfg.mlp_act).to(x.dtype) * h[..., 1, :]
    else:
        act = _act(h[..., 0, :], cfg.mlp_act).to(x.dtype)
    y = _mm(act, p["wo"])
    if cfg.mlp_bias:
        y = y + p["bo"]
    return y


# ---------------------------------------------------------------------- #
# MLA attention (deepseek-v3): low-rank Q/KV with a compressed cache
# ---------------------------------------------------------------------- #

def mla_params_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    D, H = cfg.d_model, cfg.n_heads
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq_a": (D, qr), "q_norm": (qr,),
        "wq_b": (qr, H, dn + dr),
        "wkv_a": (D, kr + dr), "kv_norm": (kr,),
        "wkv_b": (kr, H, dn + dv),
        "wo_mla": (H, dv, D),
    }


def _heads_mm(x, w):
    """x [..., H, a] against w [a, H, b] -> [..., H, b]: one product per
    head (the JAX package's ``einsum("...ha,ahb->...hb")``)."""
    lead, (H, a) = x.shape[:-2], x.shape[-2:]
    dt = torch.promote_types(x.dtype, w.dtype)
    xh = x.to(dt).reshape(-1, H, a).transpose(0, 1)           # [H, N, a]
    out = torch.bmm(xh, w.to(dt).permute(1, 0, 2))            # [H, N, b]
    return out.transpose(0, 1).reshape(*lead, H, w.shape[-1])


def mla_attention(x, p, cfg: ModelConfig, *,
                  cache: Optional[Dict[str, torch.Tensor]] = None,
                  index: Optional[int] = None):
    """DeepSeek-V3 multi-head latent attention.  x [B,S,D]; cache =
    {"latent" [B,T,kv_lora + qk_rope]}: the serving cache holds only the
    compressed latent of each token.  Returns (y, new_cache).

    Prefill expands the fresh span's latent to per-head keys [B,S,H,
    qk_nope + qk_rope] and values [B,S,H,v] and attends through
    ``attention`` (the flash kernel on the card, Dv < D; the values are a
    strided view of the expansion, no copy).  Decode with ``mla_absorb``
    folds ``wkv_b`` into the query and the output and attends in the
    latent space (KV = 1, G = H), on the direct path; without it, the
    whole cache is expanded every step.  As in ``gqa_attention`` the
    latent is written into ``cache`` in place and the same tensor
    returned."""
    B, S, D = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kr = cfg.kv_lora_rank
    pos0 = 0 if index is None else int(index)
    positions = (pos0 + torch.arange(S, device=x.device))[None, :]

    cq = rms_norm(_mm(x, p["wq_a"]), p["q_norm"], cfg.norm_eps)
    qr = cq.shape[-1]
    q = _mm(cq, p["wq_b"].reshape(qr, H * (dn + dr))).view(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    cos, sin = rope_tables(positions, dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    q_full = torch.cat([q_nope, q_rope], dim=-1)

    ckv_full = _mm(x, p["wkv_a"])                            # [B,S,kr+dr]
    ckv, k_rope = ckv_full[..., :kr], ckv_full[..., kr:]
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
    latent = torch.cat([rms_norm(ckv, p["kv_norm"], cfg.norm_eps), k_rope],
                       dim=-1)

    new_cache = None
    lat, kv_len, q_offset, causal = latent, None, 0, cfg.causal
    if cache is not None:
        lat_buf = cache["latent"]
        lat_buf[:, pos0:pos0 + S] = latent.to(lat_buf.dtype)
        new_cache = {"latent": lat_buf}
        if S == 1:                  # decode; prefill attends the fresh span
            lat, kv_len, q_offset, causal = lat_buf, pos0 + S, pos0, False
    scale = 1.0 / math.sqrt(dn + dr)

    if cache is not None and S == 1 and cfg.mla_absorb:
        # absorbed decode: wkv_b folded into the query and the output, so
        # attention runs in the latent space without expanding the cache
        wkb, wvb = p["wkv_b"][..., :dn], p["wkv_b"][..., dn:]  # [kr,H,dn|dv]
        q_eff = torch.cat([_heads_mm(q_nope, wkb.transpose(0, 2)), q_rope],
                          dim=-1)                            # [B,1,H,kr+dr]
        o_lat = attention(q_eff.reshape(B, S, 1, H, kr + dr),
                          lat[:, :, None, :], lat[:, :, None, :kr],
                          causal=False, q_offset=q_offset, kv_len=kv_len,
                          scale=scale)
        o = _heads_mm(o_lat.reshape(B, S, H, kr), wvb)         # [B,S,H,dv]
        y = _mm(o.reshape(B, S, H * dv), p["wo_mla"].reshape(H * dv, D))
        return y, new_cache

    ckv_t, krope_t = lat[..., :kr], lat[..., kr:]
    T = lat.shape[1]
    kv = _mm(ckv_t, p["wkv_b"].reshape(kr, H * (dn + dv))
             ).view(B, T, H, dn + dv)
    k_nope, vv = kv[..., :dn], kv[..., dn:]
    # per-head keys [B,T,H,dn+dr]; heads as KV groups of one (G = 1)
    k_full = torch.cat([k_nope, krope_t[:, :, None, :].expand(B, T, H, dr)],
                       dim=-1)
    o = attention(q_full.reshape(B, S, H, 1, dn + dr), k_full, vv,
                  causal=causal, q_offset=q_offset, kv_len=kv_len,
                  scale=scale)
    y = _mm(o.reshape(B, S, H * dv), p["wo_mla"].reshape(H * dv, D))
    return y, new_cache


def mla_cache_spec(cfg: ModelConfig, batch: int, max_len: int
                   ) -> Dict[str, TensorSpec]:
    width = cfg.kv_lora_rank + cfg.qk_rope_dim
    return {"latent": TensorSpec((batch, max_len, width),
                                 torch_dtype(cfg.compute_dtype))}


# ---------------------------------------------------------------------- #
# mixture of experts
# ---------------------------------------------------------------------- #

def moe_params_shapes(cfg: ModelConfig) -> Dict[str, Tuple]:
    D, E, F_ = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    shapes = {
        "router": (D, E),
        "experts": {"wi": (E, D, 2, F_), "wo": (E, F_, D)},
    }
    if cfg.n_shared_experts:
        shapes["shared"] = mlp_params_shapes(
            cfg, cfg.moe_d_ff * cfg.n_shared_experts)
    return shapes


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row and their indices, lower index first on
    ties (``lax.top_k``'s order; ``torch.topk`` leaves it unspecified)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(xt, router, K: int):
    """Router logits in fp32, softmax, top-k with renormalised gates.
    xt [T,D] -> probs [T,E], gate [T,K], gidx [T,K]."""
    logits = torch.matmul(xt.float(), router.float())        # [T,E] fp32
    probs = torch.softmax(logits, dim=-1)
    gate, gidx = top_k(probs, K)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate, gidx


def _dispatch(gidx, E: int, C: int):
    """The T·K (token, expert) pairs sorted by expert (stably) into
    per-expert buckets of C slots.  Returns (order, sorted_e, tok, slot,
    keep): the sort, each sorted pair's expert and token, its row
    e·C + position in the flattened [E·C] buffer, and whether it fits.  A
    pair at position C or more is dropped: its slot is the row E·C, one
    past the buffer, which the scatter writes and the gather never reads
    (JAX's ``mode="drop"`` / ``mode="fill"`` as masks, so every shape is
    static)."""
    flat_e = gidx.reshape(-1)                                # [T*K]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    tok = order // gidx.shape[1]
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=gidx.device))
    pos = torch.arange(flat_e.numel(), device=gidx.device) - starts[sorted_e]
    keep = pos < C
    slot = torch.where(keep, sorted_e * C + pos, E * C)
    return order, sorted_e, tok, slot, keep


def _scatter(xt, tok, slot, rows: int):
    """[rows, D] buffer with token ``tok[i]`` at row ``slot[i]``, zero
    elsewhere; dropped pairs land on a spare last row, cut off."""
    buf = xt.new_zeros((rows + 1, xt.shape[1]))
    buf[slot] = xt[tok]                  # unique rows, but for the spare
    return buf[:rows]


def _gather(out_flat, slot, keep):
    """Each sorted pair's expert output (row ``slot``), zero where dropped."""
    rows = out_flat.shape[0]
    return torch.where(keep[:, None], out_flat[slot.clamp(max=rows - 1)],
                       torch.zeros((), dtype=out_flat.dtype,
                                   device=out_flat.device))


def _experts(h, wi, wo):
    """Batched expert SwiGLU: h [E,N,D] -> [E,N,D]."""
    E, _, D = h.shape
    F_ = wo.shape[1]
    a = torch.bmm(h, wi.reshape(E, D, 2 * F_).to(h.dtype)
                  ).view(E, h.shape[1], 2, F_)
    act = F.silu(a[..., 0, :].float()).to(h.dtype) * a[..., 1, :]
    return torch.bmm(act, wo.to(h.dtype))


def _combine(contrib, gate, order, gidx):
    """Each kept output times its gate back to its token: a token's K
    contributions (zero where dropped) added one by one in ascending
    expert order, in contrib's dtype — the order of the JAX package's
    scatter-add, and the same on every run (no atomics).  contrib [T·K,D]
    in sorted order -> y [T,D]."""
    T, K = gidx.shape
    contrib = contrib * gate.reshape(-1)[order][:, None].to(contrib.dtype)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * K, device=order.device)
    rows = inv.view(T, K).gather(1, torch.argsort(gidx, dim=-1, stable=True))
    per_tok = contrib[rows]                                  # [T,K,D]
    y = per_tok[:, 0]
    for j in range(1, K):
        y = y + per_tok[:, j]
    return y


def _expert_counts(gidx, E: int):
    """How many (token, expert) pairs chose each expert (int64 [E])."""
    flat_e = gidx.reshape(-1)
    return torch.zeros(E, dtype=torch.int64, device=gidx.device
                       ).scatter_add_(0, flat_e, torch.ones_like(flat_e))


# -- expert parallelism (all-to-all dispatch) --------------------------- #
# Set by the launcher: (mesh, axes) where experts are sharded over the
# flattened ``axes`` (data-major order, matching lax.all_to_all), with the
# flattened process group, made at first use.
_EP_STATE: Optional[Dict[str, Any]] = None


def set_moe_ep(mesh, axes: Optional[Tuple[str, ...]]) -> None:
    """Turn expert parallelism on over ``axes`` of ``mesh`` (a
    ``DeviceMesh``; every rank calls this), or off with ``axes=None``."""
    global _EP_STATE
    _EP_STATE = {"mesh": mesh, "axes": tuple(axes), "group": None} \
        if axes else None


def _moe_ep_applicable(x, cfg: ModelConfig) -> bool:
    if _EP_STATE is None:
        return False
    mesh, axes = _EP_STATE["mesh"], _EP_STATE["axes"]
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if any(a not in sizes for a in axes):
        return False
    d0, m = sizes[axes[0]], sizes[axes[1]]
    B, S, _ = x.shape
    return (B % d0 == 0 and S % m == 0 and
            cfg.n_experts % (d0 * m) == 0)


def _ep_group():
    if _EP_STATE["group"] is None:
        mesh, axes = _EP_STATE["mesh"], _EP_STATE["axes"]
        _EP_STATE["group"] = mesh[axes]._flatten().get_group()
    return _EP_STATE["group"]


def _on_mesh(t, mesh, layout, grad_layout=None):
    """This rank's block of ``t`` laid out as ``layout``: a DTensor is
    redistributed to it (shard_map's ``in_specs``), a plain tensor is taken
    as the same value on every rank.  Gradients flow back in ``t``'s kind
    (a plain tensor's grad is whole on every rank); ``grad_layout`` names
    the placements of the local gradient (Partial for a replicated weight
    that each rank applies to its own tokens)."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t.redistribute(mesh, layout).to_local(grad_placements=grad_layout)


def _moe_ffn_ep(x, p, cfg: ModelConfig):
    """Expert-parallel MoE over the flattened (data, model) group of R
    ranks: each rank routes its own tokens [B/Dz, S/Mz, D], keeps E/R
    experts, and two differentiable ``all_to_all_single``s carry the
    dispatch buffer [R, E/R·C, D] there and back (C from the local token
    count).  x and the params may be DTensors on the EP mesh or plain
    tensors holding the same value on every rank; y comes back in x's kind.
    The load-balance loss needs the global mean of the router
    probabilities and the global expert counts: both are all-reduced, so
    every rank's aux is the dense path's.  Returns (y, aux)."""
    import torch.distributed as dist
    import torch.distributed.nn.functional as dnn

    mesh, axes = _EP_STATE["mesh"], _EP_STATE["axes"]
    group = _ep_group()
    names = list(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.shape))
    Dz, Mz = sizes[axes[0]], sizes[axes[1]]
    R = Dz * Mz
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    E_loc = E // R
    T, T_loc = B * S, (B // Dz) * (S // Mz)
    C = max(1, int(math.ceil(T_loc * K / E * cfg.capacity_factor)))

    def layout(**dims):
        out = [Replicate()] * mesh.ndim
        for a, d in dims.items():
            out[names.index(a)] = Shard(d)
        return out
    x_lay = layout(**{axes[0]: 0, axes[1]: 1})
    expert_lay = layout(**{axes[0]: 0, axes[1]: 0})     # data-major
    partial = [Partial() if a in axes else Replicate() for a in names]
    xl = _on_mesh(x, mesh, x_lay)
    router = _on_mesh(p["router"], mesh, [Replicate()] * mesh.ndim, partial)
    wi = _on_mesh(p["experts"]["wi"], mesh, expert_lay)
    wo = _on_mesh(p["experts"]["wo"], mesh, expert_lay)

    xt = xl.reshape(T_loc, D)
    probs, gate, gidx = _route(xt, router, K)
    order, sorted_e, tok, slot, keep = _dispatch(gidx, E, C)
    # slot = e·C + pos = dest·(E_loc·C) + (e mod E_loc)·C + pos: the send
    # buffer's R chunks, chunk r for rank r
    send = _scatter(xt, tok, slot, E * C)
    recv = dnn.all_to_all_single(torch.empty_like(send), send, group=group)
    h = recv.view(R, E_loc, C, D).transpose(0, 1).reshape(E_loc, R * C, D)
    o = _experts(h, wi, wo)
    outb = o.view(E_loc, R, C, D).transpose(0, 1).reshape(E * C, D)
    back = dnn.all_to_all_single(torch.empty_like(outb), outb, group=group)
    y = _combine(_gather(back, slot, keep), gate, order, gidx)
    y = y.reshape(xl.shape)
    if cfg.n_shared_experts:
        shared = {k: _on_mesh(v, mesh, [Replicate()] * mesh.ndim, partial)
                  for k, v in p["shared"].items()}
        y = y + mlp(xl, shared, cfg)
    y = DTensor.from_local(y, mesh, x_lay, run_check=False)
    if not isinstance(x, DTensor):
        y = y.full_tensor()

    # switch-style load-balance auxiliary over every rank's tokens
    me = DTensor.from_local(probs.mean(dim=0) * (T_loc / T), mesh, partial,
                            run_check=False).full_tensor()
    counts = _expert_counts(gidx, E)
    dist.all_reduce(counts, group=group)
    aux = cfg.router_aux_weight * E * torch.sum(me * (counts.float()
                                                      / (T * K)))
    if isinstance(x, DTensor):
        aux = DTensor.from_local(aux, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    return y, aux


def moe_ffn(x, p, cfg: ModelConfig):
    """Sort-based dropped-token MoE (the JAX package's ``moe_ffn``).
    Returns (y, aux_loss).

    Router logits in fp32, softmax, top-k with renormalised gates; the
    T·K (token, expert) pairs sorted by expert (stably) fill per-expert
    buckets of capacity C = max(1, ceil(T·K/E·capacity_factor)), a pair
    whose slot is C or more dropped; batched expert SwiGLU over [E,C,D];
    each kept output times its gate goes back to its token (``_combine``);
    plus the shared experts and the switch-style load-balance loss.  Every
    shape is static (drops through a spare row and masks), so the layer
    also runs on fake tensors (the dry run).  With EP enabled
    (``set_moe_ep``) and a compatible shape, dispatch runs as all-to-alls
    over the EP group instead (``_moe_ffn_ep``)."""
    if _moe_ep_applicable(x, cfg):
        return _moe_ffn_ep(x, p, cfg)
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    T = B * S
    xt = x.reshape(T, D)
    probs, gate, gidx = _route(xt, p["router"], K)
    C = max(1, int(math.ceil(T * K / E * cfg.capacity_factor)))
    order, sorted_e, tok, slot, keep = _dispatch(gidx, E, C)
    buf = _scatter(xt, tok, slot, E * C).view(E, C, D)
    out_buf = _experts(buf, p["experts"]["wi"], p["experts"]["wo"])
    contrib = _gather(out_buf.view(E * C, D), slot, keep)
    y = _combine(contrib, gate, order, gidx).reshape(B, S, D)

    if cfg.n_shared_experts:
        y = y + mlp(x, p["shared"], cfg)

    # switch-style load-balance auxiliary
    me = probs.mean(dim=0)                                   # [E]
    ce = _expert_counts(gidx, E).float() / (T * K)
    aux = cfg.router_aux_weight * E * torch.sum(me * ce)
    return y, aux


# ---------------------------------------------------------------------- #
# Mamba2 (SSD) mixer
# ---------------------------------------------------------------------- #

def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_head_dim, cfg.ssm_state_dim


def ssm_params_shapes(cfg: ModelConfig) -> Dict[str, Tuple]:
    D = cfg.d_model
    di, nh, hd, ds = ssm_dims(cfg)
    G = cfg.ssm_n_groups
    conv_ch = di + 2 * G * ds
    return {
        "in_proj": (D, 2 * di + 2 * G * ds + nh),   # z, x, B, C, dt
        "conv_w": (cfg.ssm_conv_width, conv_ch),
        "conv_b": (conv_ch,),
        "A_log": (nh,),
        "D_skip": (nh,),
        "dt_bias": (nh,),
        "out_norm": (di,),
        "out_proj": (di, D),
    }


def ssm_mixer(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ModelConfig,
              cache: Optional[Dict[str, torch.Tensor]] = None):
    """Mamba2 block mixer.  cache = {"conv" [B,W-1,C], "state" [B,H,P,N]}.
    Returns (out [B,S,D], new cache or None)."""
    B, S, D = x.shape
    di, nh, hd, ds = ssm_dims(cfg)
    G = cfg.ssm_n_groups
    zxbcdt = torch.matmul(x, p["in_proj"])
    # the conv reads its x, B and C columns where in_proj wrote them
    z, xBC, dt = torch.split(zxbcdt, [di, di + 2 * G * ds, nh], dim=-1)
    conv_out, new_conv = _causal_conv(
        xBC, p["conv_w"], p["conv_b"],
        state=None if cache is None else cache["conv"])
    xi, Bm, Cm = torch.split(conv_out, [di, G * ds, G * ds], dim=-1)
    xh = xi.reshape(B, S, nh, hd)
    Bm = Bm.reshape(B, S, G, ds)
    Cm = Cm.reshape(B, S, G, ds)
    dt = softplus(dt.float() + p["dt_bias"])
    if cache is None or S > 1:
        # training or prefill: chunked SSD; final state seeds decoding
        y, final = ssd_ops.ssd(xh, dt, p["A_log"], Bm, Cm,
                               chunk=min(cfg.ssm_chunk, S))
        new_cache = None if cache is None else \
            {"conv": new_conv, "state": final}
    else:
        y, new_state = ssd_ops.ssd_decode(xh, dt, p["A_log"], Bm, Cm,
                                          cache["state"])
        new_cache = {"conv": new_conv, "state": new_state}
    y = y + xh * p["D_skip"].to(y.dtype)[None, None, :, None]
    y = y.reshape(B, S, di)
    y = rms_norm(y, p["out_norm"], cfg.norm_eps)
    y = y * F.silu(z.float()).to(y.dtype)
    return torch.matmul(y, p["out_proj"]), new_cache


def ssm_cache_spec(cfg: ModelConfig, batch: int) -> Dict[str, TensorSpec]:
    di, nh, hd, ds = ssm_dims(cfg)
    G = cfg.ssm_n_groups
    conv_ch = di + 2 * G * ds
    return {
        "conv": TensorSpec((batch, cfg.ssm_conv_width - 1, conv_ch),
                           torch_dtype(cfg.compute_dtype)),
        "state": TensorSpec((batch, nh, hd, ds), torch.float32),
    }
