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
its old tensors, AdamW's in pieces of ``DONATE_PIECE`` elements, with the
same elementwise operations and so the same bits, and the step needs no
second copy of the params and moments (16 bytes a param with fp32 grads,
not 28; gemma2-9b's embedding leaf alone is 0.9 G elements).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from ..models.layers import TensorSpec
from ..tree import leaf_paths, tree_map

F32 = torch.float32
DONATE_PIECE = 1 << 26       # elements of a leaf updated in place at once


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
    total = None
    for x in leaves:
        sq = torch.sum(torch.square(x.to(F32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _update_leaf(p, g, s, scale, lr, t, beta, cfg: OptConfig, decay: bool):
    g = g.to(F32) * scale
    if cfg.name == "adamw":
        m = cfg.b1 * s["m"] + (1 - cfg.b1) * g
        v = cfg.b2 * s["v"] + (1 - cfg.b2) * g * g
        mh = m / (1 - cfg.b1 ** t)
        vh = v / (1 - cfg.b2 ** t)
        u = mh / (torch.sqrt(vh) + cfg.eps)
        new_s = {"m": m, "v": v}
    else:
        g2 = g * g + 1e-30
        if "vr" in s:
            vr = beta * s["vr"] + (1 - beta) * g2.mean(dim=-1)
            vc = beta * s["vc"] + (1 - beta) * g2.mean(dim=-2)
            denom = torch.sqrt(
                vr[..., None] / torch.clamp(
                    vr.mean(dim=-1, keepdim=True)[..., None], min=1e-30)
                * vc[..., None, :])
            new_s = {"vr": vr, "vc": vc}
        else:
            v = beta * s["v"] + (1 - beta) * g2
            denom = torch.sqrt(v)
            new_s = {"v": v}
        u = g / torch.clamp(denom, min=1e-30)
        rms = torch.sqrt(torch.mean(u * u) + 1e-30)
        u = u / torch.clamp(rms / cfg.clip_rms, min=1.0)
    if decay:
        u = u + cfg.weight_decay * p.to(F32)
    return (p.to(F32) - lr * u).to(p.dtype), new_s


def _update_leaf_in_place(p, g, s, scale, lr, t, beta, cfg: OptConfig):
    """``_update_leaf`` written into ``p`` and ``s``: AdamW piece by piece
    over the flat leaf (elementwise, so the same bits), Adafactor (whose
    factored moments reduce over the leaf) whole."""
    decay = p.dim() >= 2
    if cfg.name != "adamw":
        new_p, new_s = _update_leaf(p, g, s, scale, lr, t, beta, cfg, decay)
        p.copy_(new_p)
        for key, val in new_s.items():
            s[key].copy_(val)
        return p, s
    flat = (p.view(-1), g.reshape(-1), s["m"].view(-1), s["v"].view(-1))
    for i in range(0, p.numel(), DONATE_PIECE):
        pp, gp, mp, vp = (x[i:i + DONATE_PIECE] for x in flat)
        new_p, new_s = _update_leaf(pp, gp, {"m": mp, "v": vp}, scale, lr, t,
                                    beta, cfg, decay)
        pp.copy_(new_p)
        mp.copy_(new_s["m"])
        vp.copy_(new_s["v"])
    return p, s


def apply_updates(params, grads, state, step: torch.Tensor, cfg: OptConfig,
                  donate: bool = False
                  ) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
    """One optimizer update -> (new_params, new_state, {"lr", "grad_norm"}).
    ``step`` is the int32 step count before this update (a tensor).  With
    ``donate`` the new values are written into ``params`` and ``state``,
    which are returned (bitwise what the functional update returns)."""
    if cfg.name not in ("adamw", "adafactor"):
        raise ValueError(f"unknown optimizer {cfg.name!r}")
    lr = schedule(step, cfg)
    gnorm = _global_norm(leaf for _, leaf in leaf_paths(grads))
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0) \
        if cfg.clip_norm else 1.0
    t = step.to(F32) + 1.0
    beta = 1.0 - t ** (-cfg.decay_rate)

    def walk(p, g, s):                   # params, grads and state in step
        if isinstance(p, dict):
            pairs = {k: walk(p[k], g[k], s[k]) for k in p}
            return ({k: v[0] for k, v in pairs.items()},
                    {k: v[1] for k, v in pairs.items()})
        if donate:
            return _update_leaf_in_place(p, g, s, scale, lr, t, beta, cfg)
        return _update_leaf(p, g, s, scale, lr, t, beta, cfg, p.dim() >= 2)

    new_params, new_state = walk(params, grads, state)
    return new_params, new_state, {"lr": lr, "grad_norm": gnorm}
