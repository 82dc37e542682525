"""Optimizers of the port (the JAX package's ``optim/optimizer.py``): AdamW
for small and medium models, and factored Adafactor for 100B+ models
(second moment factored to rows and columns, no momentum).

Plain functions on trees of tensors (``repro_torch.tree``), no
``torch.optim``: the state trees mirror the param tree, every moment is
fp32, and each update follows the JAX package's operations in its order —
the global norm over all grads, one clip scale, the moments, the bias
correction, decoupled weight decay on leaves of rank >= 2 — so the two
packages' updates agree leaf by leaf from the same params, grads and
state.  New tensors are returned and nothing is updated in place, unless
the caller donates the params and state (``donate=True``, as a jitted
JAX step donates its state): then each leaf's new values are written into
its old tensors, AdamW's in pieces of ``PIECE`` elements, with the
same elementwise operations and so the same bits, and the step needs no
second copy of the params and moments (16 bytes a param with fp32 grads,
not 28; gemma2-9b's embedding leaf alone is 0.9 G elements).

Nothing takes a whole large leaf in fp32 at once: the global norm sums
each grad leaf in pieces of ``PIECE`` elements, and Adafactor updates a
leaf in pieces of its leading axes (a factored leaf's moments reduce over
its last two axes only) in two passes, since the update's RMS clip is the
one reduction over the whole leaf.  qwen2-7b's ``ffn.wi`` is 3.8 G
elements: one fp32 copy of it is 15.2 GB, the pieces are 0.27 GB.  Both
paths, functional and donated, run the same pieces.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from ..models.layers import TensorSpec
from ..trace import span
from ..tree import leaf_paths, tree_map

F32 = torch.float32
PIECE = 1 << 26              # most elements of a leaf a pass takes at once


@dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"          # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    # adafactor
    decay_rate: float = 0.8
    clip_rms: float = 1.0


def schedule(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_ratio``·lr, in fp32."""
    step = step.to(F32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def opt_state_specs(param_specs, cfg: OptConfig):
    """TensorSpec tree of the optimizer state (no allocation)."""
    def leaf(spec):
        shape = tuple(spec.shape)
        if cfg.name == "adamw":
            s = TensorSpec(shape, F32)
            return {"m": s, "v": s}
        if _factored(shape):
            return {"vr": TensorSpec(shape[:-1], F32),
                    "vc": TensorSpec(shape[:-2] + shape[-1:], F32)}
        return {"v": TensorSpec(shape, F32)}
    return tree_map(leaf, param_specs)


def init_opt_state(params, cfg: OptConfig):
    """Zero moments for ``params``, on the params' devices."""
    def leaf(p):
        specs = opt_state_specs(TensorSpec(tuple(p.shape), p.dtype), cfg)
        return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                              device=p.device), specs)
    return tree_map(leaf, params)


def _global_norm(leaves) -> torch.Tensor:
    """sqrt of Σ x² over every leaf, in fp32, each leaf taken in pieces of
    ``PIECE`` elements (no whole-leaf fp32 copy)."""
    total = None
    for x in leaves:
        for piece in _split(x, x.dim(), PIECE):
            sq = torch.sum(torch.square(piece.to(F32)))
            total = sq if total is None else total + sq
    return torch.sqrt(total)


def _adamw_leaf(p, g, s, scale, lr, t, cfg: OptConfig, decay: bool):
    g = g.to(F32) * scale
    m = cfg.b1 * s["m"] + (1 - cfg.b1) * g
    v = cfg.b2 * s["v"] + (1 - cfg.b2) * g * g
    mh = m / (1 - cfg.b1 ** t)
    vh = v / (1 - cfg.b2 ** t)
    u = mh / (torch.sqrt(vh) + cfg.eps)
    if decay:
        u = u + cfg.weight_decay * p.to(F32)
    return (p.to(F32) - lr * u).to(p.dtype), {"m": m, "v": v}


def _adamw_in_place(p, g, s, scale, lr, t, cfg: OptConfig):
    """``_adamw_leaf`` written into ``p`` and ``s`` piece by piece over the
    flat leaf (elementwise, so the same bits)."""
    decay = p.dim() >= 2
    flat = (p.view(-1), g.reshape(-1), s["m"].view(-1), s["v"].view(-1))
    for i in range(0, p.numel(), PIECE):
        pp, gp, mp, vp = (x[i:i + PIECE] for x in flat)
        new_p, new_s = _adamw_leaf(pp, gp, {"m": mp, "v": vp}, scale, lr, t,
                                   cfg, decay)
        pp.copy_(new_p)
        mp.copy_(new_s["m"])
        vp.copy_(new_s["v"])
    return p, s


def _adafactor_split(p: torch.Tensor, factored: bool):
    """(k, n): a leaf's Adafactor pieces merge its first ``k`` axes and
    take ``n`` rows of the merged axis at a time.  A factored leaf's
    moments reduce over its last two axes only, so the axes before them
    split; every axis of an unfactored leaf does.  A piece holds at most
    ``PIECE`` elements, or one row; k = 0 is the whole leaf."""
    k = p.dim() - 2 if factored else p.dim()
    if k <= 0:
        return 0, 1
    return k, max(1, PIECE // max(math.prod(p.shape[k:]), 1))


def _split(x: torch.Tensor, k: int, n: int, out: bool = False):
    """``x``'s pieces: its first ``k`` axes merged, ``n`` rows a piece
    (views; a piece that is written must be one)."""
    if not k:
        return [x]
    merged = (x.view if out else x.reshape)(-1, *x.shape[k:])
    return list(merged.split(n))


def _adafactor_moments(g, s, scale, beta):
    """(g scaled, g²'s new moments) of one piece, the JAX package's
    operations."""
    g = g.to(F32) * scale
    g2 = g * g + 1e-30
    if "vr" in s:
        return g, {"vr": beta * s["vr"] + (1 - beta) * g2.mean(dim=-1),
                   "vc": beta * s["vc"] + (1 - beta) * g2.mean(dim=-2)}
    return g, {"v": beta * s["v"] + (1 - beta) * g2}


def _adafactor_direction(g, s):
    """The unclipped update g / sqrt(v̂) of one piece from its new
    moments."""
    if "vr" in s:
        vr, vc = s["vr"], s["vc"]
        denom = torch.sqrt(
            vr[..., None] / torch.clamp(
                vr.mean(dim=-1, keepdim=True)[..., None], min=1e-30)
            * vc[..., None, :])
    else:
        denom = torch.sqrt(s["v"])
    return g / torch.clamp(denom, min=1e-30)


def _clip_rms(sums, sizes):
    """The update's RMS over the whole leaf from each piece's Σu² and
    element count, one value for each piece (the clip is a whole-leaf
    reduction)."""
    rms = torch.sqrt(sum(sums) / sum(sizes) + 1e-30)
    return [rms] * len(sums)


def _adafactor_leaf(p, g, s, scale, lr, t, beta, cfg: OptConfig,
                    new_p, new_s):
    """Adafactor's update of one leaf written into ``new_p`` and ``new_s``
    (``p`` and ``s`` themselves when donated), in pieces of its leading
    axes (``_adafactor_split``) and two passes: the new moments and Σu²
    of every piece, then the update clipped by the whole leaf's RMS.  The
    second pass recomputes u from the new moments with the same
    operations, so each element's value is the whole-leaf update's; only
    the order of the sums differs."""
    k, n = _adafactor_split(p, "vr" in s)
    names = sorted(s)
    gs = _split(g, k, n)
    olds = [_split(s[m], k, n) for m in names]
    news = [_split(new_s[m], k, n, out=True) for m in names]
    sums, sizes = [], []
    for i, gi in enumerate(gs):
        gi, st = _adafactor_moments(
            gi, {m: old[i] for m, old in zip(names, olds)}, scale, beta)
        for m, new in zip(names, news):
            new[i].copy_(st[m])
        u = _adafactor_direction(gi, st)
        sums.append(torch.sum(u * u))
        sizes.append(u.numel())
    decay = p.dim() >= 2
    ps, outs = _split(p, k, n), _split(new_p, k, n, out=True)
    for i, rms in enumerate(_clip_rms(sums, sizes)):
        u = _adafactor_direction(gs[i].to(F32) * scale,
                                 {m: new[i] for m, new in zip(names, news)})
        u = u / torch.clamp(rms / cfg.clip_rms, min=1.0)
        if decay:
            u = u + cfg.weight_decay * ps[i].to(F32)
        outs[i].copy_((ps[i].to(F32) - lr * u).to(p.dtype))
    return new_p, new_s


def apply_updates(params, grads, state, step: torch.Tensor, cfg: OptConfig,
                  donate: bool = False
                  ) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
    """One optimizer update -> (new_params, new_state, {"lr", "grad_norm"}).
    ``step`` is the int32 step count before this update (a tensor).  With
    ``donate`` the new values are written into ``params`` and ``state``,
    which are returned (bitwise what the functional update returns)."""
    if cfg.name not in ("adamw", "adafactor"):
        raise ValueError(f"unknown optimizer {cfg.name!r}")
    with span("optim.apply_updates"):
        lr = schedule(step, cfg)
        gnorm = _global_norm(leaf for _, leaf in leaf_paths(grads))
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0) \
            if cfg.clip_norm else 1.0
        t = step.to(F32) + 1.0
        beta = 1.0 - t ** (-cfg.decay_rate)

        def walk(p, g, s):               # params, grads and state in step
            if isinstance(p, dict):
                pairs = {k: walk(p[k], g[k], s[k]) for k in p}
                return ({k: v[0] for k, v in pairs.items()},
                        {k: v[1] for k, v in pairs.items()})
            if cfg.name == "adamw" and donate:
                return _adamw_in_place(p, g, s, scale, lr, t, cfg)
            if cfg.name == "adamw":
                return _adamw_leaf(p, g, s, scale, lr, t, cfg, p.dim() >= 2)
            if donate:
                return _adafactor_leaf(p, g, s, scale, lr, t, beta, cfg, p, s)
            return _adafactor_leaf(
                p, g, s, scale, lr, t, beta, cfg, torch.empty_like(p),
                {k: torch.empty_like(v) for k, v in s.items()})

        new_params, new_state = walk(params, grads, state)
        return new_params, new_state, {"lr": lr, "grad_norm": gnorm}
