"""Training step (the JAX package's ``train/step.py``).

A train state is ``{"params", "opt", "step"}``: the params tree, the
optimizer's moment tree and an int32 step count, all tensors on the
trainer's device.  ``train_step`` runs eagerly (no ``torch.compile``, no
CUDA graph): the differentiated ``forward_train`` (each SSM mixer's scan
on the SSD kernel and its gradient on the backward kernel on the card),
``torch.autograd.grad`` for every param leaf, then the optimizer.

``journal=True`` adds the integrity record of the step: one hash per grad
leaf (``kernels/checksum/ops.tree_checksums``, on the hash kernel on the
card), the summary that the paper's journal records beside the step.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..kernels.checksum import ops as cksum
from ..models import model as M
from ..models.config import ModelConfig
from ..models.layers import TensorSpec
from ..optim import OptConfig, apply_updates, init_opt_state, \
    opt_state_specs
from ..trace import span
from ..tree import leaf_paths, map_with_path


def train_state_specs(cfg: ModelConfig, opt_cfg: OptConfig):
    pspecs = M.param_specs(cfg)
    return {"params": pspecs, "opt": opt_state_specs(pspecs, opt_cfg),
            "step": TensorSpec((), torch.int32)}


def init_train_state(cfg: ModelConfig, opt_cfg: OptConfig,
                     generator: torch.Generator, device="cuda"):
    """Params from ``generator`` (``init_params``), zero moments, step 0,
    on ``device`` (the card unless the caller passes the CPU)."""
    params = M.init_params(cfg, generator, device=device)
    return {"params": params, "opt": init_opt_state(params, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32,
                                device=generator.device)}


def grads_and_metrics(params, batch: Dict[str, torch.Tensor],
                      cfg: ModelConfig) -> Tuple[Any, Dict[str, Any]]:
    """(grads, metrics) of ``forward_train`` at ``params``: a grad tree of
    the params' structure (each grad in its leaf's dtype), and the
    forward's metrics, detached."""
    names = [n for n, _ in leaf_paths(params)]
    leaves = [t.detach().requires_grad_(True) for _, t in leaf_paths(params)]
    by_name = dict(zip(names, leaves))
    with torch.enable_grad():
        with span("step.forward"):
            loss, metrics = M.forward_train(
                map_with_path(lambda n, _: by_name[n], params), cfg, batch)
        with span("step.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    g = {n: torch.zeros_like(t) if gr is None else gr
         for n, t, gr in zip(names, leaves, grads)}
    return (map_with_path(lambda n, _: g[n], params),
            {k: v.detach() for k, v in metrics.items()})


def train_step(state, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
               opt_cfg: OptConfig, journal: bool = False, donate: bool = False
               ) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """One optimizer step -> (new_state, metrics).  Metrics: "ce", "aux",
    "loss" (and "mtp"), "lr", "grad_norm" and, with ``journal``,
    "integrity" (int64 [n_leaves], one hash per grad leaf).  With
    ``donate`` the params and moments of ``state`` are updated in place
    (``apply_updates``): the caller gives up the old state."""
    grads, metrics = grads_and_metrics(state["params"], batch, cfg)
    return apply_step(state, grads, metrics, opt_cfg, journal, donate)


def apply_step(state, grads, metrics: Dict[str, torch.Tensor],
               opt_cfg: OptConfig, journal: bool = False,
               donate: bool = False) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """The optimizer half of ``train_step``, given the grads."""
    new_params, new_opt, opt_metrics = apply_updates(
        state["params"], grads, state["opt"], state["step"], opt_cfg, donate)
    metrics = {**metrics, **opt_metrics}
    if journal:
        with span("step.hash"):
            metrics["integrity"] = cksum.tree_checksums(grads)
    new_state = {"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1}
    return new_state, metrics
