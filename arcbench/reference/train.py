"""The training reference: the first steps of a train cell, plainly.

From the same weights and the same batches as the program, in float32:
the mean cross-entropy over the labels that are not -1, its gradient by
autograd (rows in blocks, summed), and AdamW as the configuration states
it — the global norm clip, bias-corrected moments, decoupled weight decay
on every stored leaf of rank two or more, the learning rate warmed up
linearly from 0 and decayed on a cosine.

``follow`` returns what the program is held to: each step's loss, each
leaf's norm of the first step's clipped gradient, and each leaf's norm of
the parameters' change over the steps.  Given another run's first clipped
gradient (``judge``, host tensors by leaf), it also returns each leaf's
norm of the difference from its own.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch

from . import model as ref


def lr_at(step: int, o: dict) -> float:
    warm = min(step / max(o["warmup_steps"], 1), 1.0)
    prog = min(max((step - o["warmup_steps"]) /
                   max(o["decay_steps"] - o["warmup_steps"], 1), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return o["lr"] * warm * (o["min_lr_ratio"] + (1 - o["min_lr_ratio"]) * cos)


class Leaves:
    """The float32 parameters being trained: each stored leaf as one
    tensor, and the leaves autograd sees — a block leaf's layers as views
    of it, one a layer, so that each layer's gradient lands in its own
    slice with no stacked copy."""

    def __init__(self, start: Dict[str, torch.Tensor], n_layers: int):
        self.full = {n: t.detach().float().clone() for n, t in start.items()}
        self.layers = [dict() for _ in range(n_layers)]
        self.grad_of = {}                   # leaf -> [autograd leaves]
        self.top = {}
        for n, t in self.full.items():
            key = ref.block_key(n)
            if key is None:
                self.top[n] = t.requires_grad_(True)
                self.grad_of[n] = [t]
            else:
                views = [v.requires_grad_(True) for v in t.unbind(0)]
                for i, v in enumerate(views):
                    self.layers[i][key] = v
                self.grad_of[n] = views

    def grads(self, n: str):
        """The leaf's gradient, a layer at a time."""
        return [v.grad if v.grad is not None else torch.zeros_like(v)
                for v in self.grad_of[n]]

    def zero(self) -> None:
        for vs in self.grad_of.values():
            for v in vs:
                v.grad = None


def loss_and_grads(p: Leaves, m: dict, batch, ops: ref.Ops, rows: int,
                   half: bool = False) -> float:
    """The mean loss over the batch, ``rows`` rows at a time, its gradient
    left in ``p``'s leaves; with ``half`` only the first half of the rows
    counts (a planted fault)."""
    tokens, labels = batch["tokens"], batch["labels"]
    if half:
        tokens, labels = tokens[:tokens.shape[0] // 2], \
            labels[:labels.shape[0] // 2]
    count = int((labels != -1).sum())
    p.zero()
    total = 0.0
    for r in range(0, tokens.shape[0], rows):
        part = ref.nll_sum(p.top, m, tokens[r:r + rows], labels[r:r + rows],
                           ops, layers=p.layers) / count
        part.backward()
        total += float(part.detach())
    return total


def follow(weights: Callable[[], Dict[str, torch.Tensor]], m: dict,
           batches: List[dict], o: dict, ops: ref.Ops, rows: int,
           half: bool = False,
           judge: Optional[Dict[str, torch.Tensor]] = None,
           keep_first: bool = False) -> dict:
    """``weights()`` gives the starting weights (in their stored dtypes);
    ``batches`` one batch a step.  With ``judge``, "first_err" is each
    leaf's ||judge - the first clipped gradient||; else, with
    ``keep_first``, "first_tensors" is that gradient itself, on the
    host."""
    ref.no_tf32()
    start = weights()
    dtypes = {n: t.dtype for n, t in start.items()}
    p = Leaves(start, m["n_layers"])
    del start
    with torch.no_grad():
        for n, full in p.full.items():
            ops.store(full, dtypes[n])
    mom = {n: torch.zeros_like(t) for n, t in p.full.items()}
    vel = {n: torch.zeros_like(t) for n, t in p.full.items()}
    losses, first, raw, err, kept = [], {}, {}, {}, {}
    for step, batch in enumerate(batches):
        losses.append(loss_and_grads(p, m, batch, ops, rows, half))
        norms = {n: math.sqrt(sum(float(g.double().pow(2).sum())
                                  for g in p.grads(n)))
                 for n in p.full}
        gnorm = math.sqrt(sum(v * v for v in norms.values()))
        scale = min(o["clip_norm"] / (gnorm + 1e-9), 1.0) \
            if o["clip_norm"] else 1.0
        lr, t = lr_at(step, o), step + 1
        with torch.no_grad():
            for n, full in p.full.items():
                if step == 0:
                    first[n] = norms[n] * scale
                    raw[n] = norms[n]
                    if judge is not None or keep_first:
                        _first_leaf(n, p.grads(n), scale, judge, err, kept)
                decay = full.dim() >= 2
                split = (lambda x: x.unbind(0)) if ref.block_key(n) \
                    else (lambda x: [x])
                for pl, gl, ml, vl in zip(split(full), p.grads(n),
                                          split(mom[n]), split(vel[n])):
                    for pp, gp, mp, vp in zip(*(pieces(x) for x in (
                            pl, gl, ml, vl))):
                        g = gp * scale
                        mp.mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
                        vp.mul_(o["b2"]).addcmul_(g, g, value=1 - o["b2"])
                        u = (mp / (1 - o["b1"] ** t)) / \
                            (torch.sqrt(vp / (1 - o["b2"] ** t)) + o["eps"])
                        if decay:
                            u = u + o["weight_decay"] * pp
                        pp.sub_(lr * u)
                ops.store(full, dtypes[n])
        p.zero()
    del mom, vel
    start = weights()
    change = {n: float((p.full[n].detach() - start[n].float()).norm())
              for n in p.full}
    out = {"losses": losses, "first_grad": first, "raw_grad": raw,
           "change": change,
           "size": {n: t.numel() for n, t in p.full.items()}}
    if judge is not None:
        out["first_err"] = err
    if keep_first:
        out["first_tensors"] = kept
    return out


def _first_leaf(n: str, grads, scale: float, judge, err: dict,
                kept: dict) -> None:
    """Leaf ``n``'s first clipped gradient, a layer at a time: its distance
    from ``judge[n]`` into ``err``, or a host copy into ``kept``."""
    block = ref.block_key(n) is not None
    other = None if judge is None else \
        (judge[n].unbind(0) if block else [judge[n]])
    total, parts = 0.0, []
    for i, g in enumerate(grads):
        g = g * scale
        if other is not None:
            total += float((g - other[i].to(g.device).float())
                           .double().pow(2).sum())
        else:
            parts.append(g.cpu())
    if other is not None:
        err[n] = math.sqrt(total)
    else:
        kept[n] = torch.stack(parts) if block else parts[0]


def gaps(prog: dict, want: dict, null_share: float = 1e-3) -> dict:
    """The program's readings against the reference's: the worst relative
    gap of the losses, and the worst leaf's gap of the first gradient's
    norm and of the change's norm, each against the larger of the leaf's
    reference norm and the median leaf's.  Leaves whose reference
    gradient, per element (its RMS), is under ``null_share`` of the
    median leaf's (nought but for rounding, as a key bias's under
    softmax) move by round-off alone and are left out of the change.
    Where either side carries "first_err", the worst leaf's norm of the
    first gradients' difference, against the same norms, is "grad_err"."""
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                           zip(prog["losses"], want["losses"]))}
    rms = {n: g / want["size"][n] ** 0.5 for n, g in want["raw_grad"].items()}
    med_rms = _median(rms.values())
    null = [n for n in rms if rms[n] < null_share * med_rms]
    for key, name in (("first_grad", "grad_gap"), ("change", "change_gap")):
        ref_n = want[key]
        keep = [n for n in ref_n if key == "first_grad" or n not in null]
        med = _median(ref_n[n] for n in keep)
        out[name] = max(abs(prog[key][n] - ref_n[n]) / max(ref_n[n], med)
                        for n in keep)
        out[name + "_leaf"] = max(keep, key=lambda n: abs(
            prog[key][n] - ref_n[n]) / max(ref_n[n], med))
    errs = want.get("first_err") or prog.get("first_err")
    if errs:
        med = _median(want["first_grad"].values())
        rel = {n: errs[n] / max(want["first_grad"][n], med) for n in errs}
        out["grad_err"] = max(rel.values())
        out["grad_err_leaf"] = max(rel, key=rel.get)
    out["null_leaves"] = null
    return out


def pieces(x: torch.Tensor, n: int = 1 << 24):
    """Views of ``x`` flattened, ``n`` elements at a time."""
    flat = x.view(-1)
    return [flat[i:i + n] for i in range(0, flat.numel(), n)]


def _median(values) -> float:
    v = sorted(values)
    n = len(v)
    return 0.0 if not n else (v[n // 2] if n % 2 else
                              0.5 * (v[n // 2 - 1] + v[n // 2]))
