"""The model stack's serving path in PyTorch (the JAX package's
``models/model.py``).

Params are nested dicts of tensors with the JAX package's structure and
names: ``embed/w``, ``blocks/l{i}/{ln1,ssm}/...`` with a leading
``[n_blocks, ...]`` axis on every block leaf (the JAX package scans over
it; the port loops over it in Python), ``final_norm/w``.

Public entry points:

  param_specs(cfg)                        — TensorSpec tree (no allocation)
  init_params(cfg, generator, device)     — seeded initialisation
  cast_params(params, cfg)                — the compute-dtype cast, once
  cache_specs(cfg, batch, max_len) / init_cache(...)
  serve_step(params, cfg, batch, cache, index) — prefill & decode
  forward_train(params, cfg, batch)       — (loss, metrics), differentiable
  set_activation_spec(spec)               — the residual stream's sharding

Every layer of the ten configs runs here: GQA attention (with gemma2's
local/global alternation, softcaps and post-norms, and command-r's
parallel block), MLA attention with its latent cache and deepseek's dense
prologue, dense MLP, MoE and SSM layers, and the frame (hubert) and patch
(llava-next) frontends.

Training keeps the params as they are stored (fp32 master params where
the config says so) and casts each layer's matrices to the compute dtype
inside the layer (``_cast_compute``, the JAX package's policy), so the
gradients land on the stored leaves; ``cast_params`` is serving's one-off
cast and training never calls it.  With ``cfg.remat == "block"`` each
block of a differentiated forward runs under ``torch.utils.checkpoint``
(non-reentrant): only its input is kept, and the block runs again in the
backward pass, as ``jax.checkpoint(..., nothing_saveable)`` does, so an
attention layer of a block runs its flash forward twice a step and its
flash backward once (the dense prologue and the MTP block, outside the
blocks, once each).  On the card the SSM mixer's scan and the attention
each have a hand-written gradient kernel.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..distributed.sharding import placements
from ..trace import span
from ..tree import leaf_paths, map_with_path, tree_map
from . import layers as L
from .config import LayerKind, ModelConfig
from .layers import TensorSpec, torch_dtype

Params = Dict[str, Any]

_FP32_KEYS = ("norm", "a_log", "dt_bias", "d_skip")

# Activation-sharding constraint for the residual stream [B, S, D].
# Set by the launcher so model code stays mesh-agnostic; None = leave the
# residual stream as it comes.
_ACT_SPEC: Optional[Tuple] = None


def set_activation_spec(spec) -> None:
    """spec: a JAX-shaped spec (``distributed.sharding``) for [batch, seq,
    d_model] activations, or None to disable.  Applied to the residual
    stream at the embed boundary and at every block boundary: a DTensor
    residual stream is redistributed to it there (the JAX package's
    ``with_sharding_constraint``)."""
    global _ACT_SPEC
    _ACT_SPEC = None if spec is None else tuple(spec)


def _constrain(h):
    if _ACT_SPEC is None or not isinstance(h, DTensor):
        return h
    return h.redistribute(h.device_mesh, placements(_ACT_SPEC, h.device_mesh))


# ---------------------------------------------------------------------- #
# parameter specs
# ---------------------------------------------------------------------- #

def _spec_tree(shapes, cfg: ModelConfig) -> Dict[str, Any]:
    """shape-dict -> TensorSpec tree; norms/SSM scalars kept fp32."""
    def rec(prefix, node):
        out = {}
        for k, v in node.items():
            path = prefix + "/" + k
            if isinstance(v, dict):
                out[k] = rec(path, v)
            else:
                fp32 = any(key in path.lower() for key in _FP32_KEYS)
                out[k] = TensorSpec(tuple(v), torch.float32 if fp32
                                    else torch_dtype(cfg.param_dtype))
        return out
    return rec("", shapes)


def _layer_shapes(cfg: ModelConfig, kind: LayerKind) -> Dict[str, Any]:
    D = cfg.d_model
    s: Dict[str, Any] = {"ln1": {"w": (D,)}}
    if kind.mixer == "attn":
        s["attn"] = L.mla_params_shapes(cfg) if cfg.use_mla \
            else L.gqa_params_shapes(cfg)
    else:
        s["ssm"] = L.ssm_params_shapes(cfg)
    has_ffn = kind.moe or cfg.d_ff > 0
    if not has_ffn:                      # mamba2: layer = mixer only
        return s
    if not cfg.parallel_block:
        s["ln2"] = {"w": (D,)}
    s["ffn"] = L.moe_params_shapes(cfg) if kind.moe \
        else L.mlp_params_shapes(cfg, cfg.d_ff)
    if cfg.use_post_norm:
        s["post_ln1"] = {"w": (D,)}
        s["post_ln2"] = {"w": (D,)}
    return s


def param_specs(cfg: ModelConfig) -> Params:
    D, V = cfg.d_model, cfg.vocab_size
    shapes: Dict[str, Any] = {}
    if cfg.input_kind in ("tokens", "tokens+patches"):
        shapes["embed"] = {"w": (V, D)}
    if cfg.input_kind == "frames":
        shapes["frame_proj"] = {"w": (cfg.frontend_dim, D), "b": (D,)}
    if cfg.input_kind == "tokens+patches":
        shapes["patch_proj"] = {"w": (cfg.frontend_dim, D), "b": (D,)}
    dense_kind = LayerKind(mixer="attn", moe=False, local=False)
    for i in range(cfg.first_dense_layers):
        shapes[f"dense{i}"] = _layer_shapes(cfg, dense_kind)
    shapes["blocks"] = {f"l{i}": _layer_shapes(cfg, kind)
                        for i, kind in enumerate(cfg.block_pattern())}
    shapes["final_norm"] = {"w": (D,)}
    if not cfg.tie_embeddings or cfg.input_kind == "frames":
        shapes["lm_head"] = {"w": (D, V)}
    if cfg.mtp_depth:
        shapes["mtp"] = {"proj": {"w": (2 * D, D)},
                         "block": _layer_shapes(cfg, dense_kind),
                         "norm": {"w": (D,)}}
    specs = _spec_tree(shapes, cfg)
    # stack the block along a leading n_blocks axis
    nb = cfg.n_blocks
    specs["blocks"] = tree_map(lambda s: TensorSpec((nb, *s.shape), s.dtype),
                               specs["blocks"])
    return specs


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Params:
    """Tensors matching ``param_specs`` on ``device`` (the card unless the
    caller passes the CPU), drawn from ``generator`` (which must live on
    that device) with the JAX package's distributions, leaf by leaf in
    its (sorted) order.  The two packages' generators give different
    numbers from one seed; tests hand both the same numpy values.

    Each leaf is allocated once in its own dtype and filled piece by
    piece: a block leaf one block's slice at a time (the leading
    ``n_blocks`` axis), any other leaf in runs of rows no larger than the
    largest block slice.  Each piece is drawn in fp32, scaled and copied
    in, so the largest fp32 transient is one block's slice of the largest
    leaf (qwen2-7b's ``ffn.wi`` slice is 0.54 GB where the leaf is 15.2 GB
    in fp32)."""
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, params on {device}")
    f32 = dict(dtype=torch.float32, device=device)
    specs = param_specs(cfg)
    piece = max(math.prod(s.shape[1:])
                for _, s in leaf_paths(specs["blocks"]))

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator, **f32) * (hi - lo) + lo

    def draw(name: str, full_shape, shape) -> torch.Tensor:
        """fp32 values of a piece of ``shape`` of the leaf ``name``."""
        if "a_log" in name:
            return torch.log(uniform(shape, 1.0, 16.0))
        if "dt_bias" in name:
            u = uniform(shape, 1e-3, 1e-1)
            return u + torch.log(-torch.expm1(-u))      # softplus^-1
        fan_in = full_shape[-2] if len(full_shape) >= 2 else full_shape[-1]
        scale = 0.02 if fan_in <= 0 else min(0.02, fan_in ** -0.5)
        return torch.randn(shape, generator=generator, **f32).mul_(scale)

    def init(name: str, spec: TensorSpec) -> torch.Tensor:
        name = name.lower()
        shape, dtype = spec.shape, spec.dtype
        if "a_log" not in name and "dt_bias" not in name:
            if "d_skip" in name:
                return torch.ones(shape, dtype=dtype, device=device)
            if name.endswith("['b']") or "ln" in name or "norm" in name:
                return torch.zeros(shape, dtype=dtype, device=device)
        out = torch.empty(shape, dtype=dtype, device=device)
        rows = 1 if name.startswith("['blocks']") else \
            max(1, piece // max(math.prod(shape[1:]), 1))
        for part in out.split(rows):
            part.copy_(draw(name, shape, part.shape))
        return out

    values = {name: init(name, spec) for name, spec in leaf_paths(specs)}
    return map_with_path(lambda name, _: values[name], specs)


# ---------------------------------------------------------------------- #
# forward machinery
# ---------------------------------------------------------------------- #

def _cast_compute(p, cfg: ModelConfig, stacked: int = 0):
    """Mixed-precision policy: matmul weights (ndim>=2, floating) compute
    in compute_dtype regardless of storage dtype; 1-D leaves (norm gains,
    A_log, dt_bias, biases) keep their own (fp32) semantics.  ``stacked``
    leading axes (the blocks' ``[n_blocks, ...]``) do not count toward a
    leaf's rank."""
    dt = torch_dtype(cfg.compute_dtype)

    def conv(a):
        if isinstance(a, torch.Tensor) and a.dim() - stacked >= 2 and \
                a.is_floating_point() and a.dtype != dt:
            return a.to(dt)
        return a
    return tree_map(conv, p)


def cast_params(params: Params, cfg: ModelConfig) -> Params:
    """``params`` with the leaves the forward casts already in the compute
    dtype: the embedding and every leaf that is a matrix within its layer
    (a block leaf's stacked axis does not count).  Per-layer vectors —
    norm gains, A_log, dt_bias, D_skip, the conv bias — stay fp32, as the
    forward keeps them.  The forward's own casts of the cast leaves then
    have nothing to do, and its values are bitwise those of ``params``."""
    return {k: _cast_compute(v, cfg, stacked=int(k == "blocks"))
            for k, v in params.items()}


def _norm(x, w, cfg: ModelConfig):
    with span("model.norm"):
        return L.rms_norm(x, w, cfg.norm_eps)


def _apply_layer(h, p, cfg: ModelConfig, kind: LayerKind, cache, index):
    """One residual layer.  Returns (h, new_cache, aux)."""
    with span("model.cast"):
        p = _cast_compute(p, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    u = _norm(h, p["ln1"]["w"], cfg)
    if kind.mixer == "attn" and cfg.use_mla:
        with span("model.mixer.mla"):
            mix, new_cache = L.mla_attention(u, p["attn"], cfg, cache=cache,
                                             index=index)
    elif kind.mixer == "attn":
        with span("model.mixer.attn"):
            mix, new_cache = L.gqa_attention(u, p["attn"], cfg,
                                             local=kind.local, cache=cache,
                                             index=index)
    else:
        with span("model.mixer.ssm"):
            mix, new_cache = L.ssm_mixer(u, p["ssm"], cfg, cache=cache)
    if "ffn" not in p:                         # mamba2: mixer-only layer
        return h + mix, new_cache, aux
    if cfg.parallel_block:                     # command-r: shared-norm ||
        with span("model.mlp"):
            ff = L.mlp(u, p["ffn"], cfg)
        return h + mix + ff, new_cache, aux
    if cfg.use_post_norm:
        mix = _norm(mix, p["post_ln1"]["w"], cfg)
    h = h + mix
    u2 = _norm(h, p["ln2"]["w"], cfg)
    if kind.moe:
        with span("model.moe"):
            ff, aux = L.moe_ffn(u2, p["ffn"], cfg)
    else:
        with span("model.mlp"):
            ff = L.mlp(u2, p["ffn"], cfg)
    if cfg.use_post_norm:
        ff = _norm(ff, p["post_ln2"]["w"], cfg)
    return h + ff, new_cache, aux


def _layer_cache_spec(cfg: ModelConfig, kind: LayerKind, batch: int,
                      max_len: int):
    if kind.mixer == "ssm":
        return L.ssm_cache_spec(cfg, batch)
    if cfg.use_mla:
        return L.mla_cache_spec(cfg, batch, max_len)
    return L.gqa_cache_spec(cfg, batch, max_len)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    """Serving state: stacked per-block caches + dense-layer caches."""
    block = {f"l{i}": _layer_cache_spec(cfg, kind, batch, max_len)
             for i, kind in enumerate(cfg.block_pattern())}
    nb = cfg.n_blocks
    out = {"blocks": tree_map(lambda s: TensorSpec((nb, *s.shape), s.dtype),
                              block)}
    dense_kind = LayerKind(mixer="attn")
    for i in range(cfg.first_dense_layers):
        out[f"dense{i}"] = _layer_cache_spec(cfg, dense_kind, batch, max_len)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    device = resolve_device(device)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device),
                    cache_specs(cfg, batch, max_len))


def apply_block(bp, h, cfg: ModelConfig, bc=None, index=None):
    """Apply one block (one repetition of the layer pattern).
    Returns (h, new_block_cache, aux)."""
    ncs = {}
    aux_acc = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, kind in enumerate(cfg.block_pattern()):
        c = None if bc is None else bc[f"l{i}"]
        h, nc, aux = _apply_layer(h, bp[f"l{i}"], cfg, kind, c, index)
        aux_acc = aux_acc + aux
        ncs[f"l{i}"] = nc if nc is not None else {}
    return h, ncs, aux_acc


def _write_into(dst, src) -> None:
    """Copy each leaf of ``src`` into the same leaf of ``dst`` (a view into
    the stacked cache), unless the layer already wrote it in place."""
    if isinstance(dst, dict):
        for k in dst:
            _write_into(dst[k], src[k])
    elif src is not dst:
        dst.copy_(src)


def _run_stack(params: Params, cfg: ModelConfig, h, cache, index):
    """Dense prologue + the blocks, in order.  Returns (h, cache, aux), with
    ``cache`` updated in place (``serve_step``)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    dense_kind = LayerKind(mixer="attn")
    for i in range(cfg.first_dense_layers):
        c = None if cache is None else cache[f"dense{i}"]
        h, nc, aux = _apply_layer(h, params[f"dense{i}"], cfg, dense_kind,
                                  c, index)
        aux_total = aux_total + aux
        if cache is not None:
            _write_into(c, nc)
    remat = cache is None and cfg.remat == "block" and \
        torch.is_grad_enabled() and (h.requires_grad or any(
            t.requires_grad for _, t in leaf_paths(params["blocks"])))
    # one unbind per leaf: its backward stacks the blocks' grads once
    slices = {n: t.unbind(0) for n, t in leaf_paths(params["blocks"])}
    for b in range(cfg.n_blocks):
        bp = map_with_path(lambda n, _: slices[n][b], params["blocks"])
        bc = None if cache is None else \
            tree_map(lambda t: t[b], cache["blocks"])
        h = _constrain(h)
        if remat:
            h, aux = checkpoint(_remat_block, bp, h, cfg,
                                use_reentrant=False)
        else:
            h, ncs, aux = apply_block(bp, h, cfg, bc, index)
            if cache is not None:
                _write_into(bc, ncs)
        h = _constrain(h)
        aux_total = aux_total + aux
    return h, cache, aux_total


def _remat_block(bp, h, cfg: ModelConfig):
    h, _, aux = apply_block(bp, h, cfg)
    return h, aux


def _embed_inputs(params: Params, cfg: ModelConfig, batch: Dict[str, Any]):
    """Token / frame / patch inputs -> [B,S,D] activations in the compute
    dtype.  The frontends are stubs, as in the JAX package: frames and
    patches arrive as precomputed embeddings and go through one learned
    projection each; a VLM's patches come before its tokens."""
    with span("model.embed"):
        dt = torch_dtype(cfg.compute_dtype)

        def project(x, proj):
            return torch.matmul(x.to(dt), proj["w"].to(dt)) + \
                proj["b"].to(dt)

        if cfg.input_kind == "frames":
            return project(batch["frames"], params["frame_proj"])
        parts = []
        if cfg.input_kind == "tokens+patches" and "patches" in batch:
            parts.append(project(batch["patches"], params["patch_proj"]))
        if "tokens" in batch:
            ht = params["embed"]["w"].to(dt)[batch["tokens"]]
            if cfg.scale_embeddings:          # gemma-style embed scaling
                ht = ht * torch.tensor(math.sqrt(cfg.d_model), dtype=dt)
            parts.append(ht)
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _logits(params: Params, cfg: ModelConfig, h):
    """The final norm and the LM head at every position."""
    with span("model.logits"):
        h = L.rms_norm(h, params["final_norm"]["w"], cfg.norm_eps)
        if cfg.tie_embeddings and cfg.input_kind != "frames":
            logits = torch.matmul(h, params["embed"]["w"].to(h.dtype).t())
        else:
            logits = torch.matmul(h, params["lm_head"]["w"].to(h.dtype))
        return L.softcap(logits, cfg.final_logit_softcap)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore: int = -1) -> torch.Tensor:
    """fp32 cross-entropy with an ignore mask; logits [B,S,V] (any float
    dtype), in the JAX package's operations: max-shifted log-sum-exp minus
    the gold logit, averaged over the labels that are not ``ignore``."""
    with span("model.loss"):
        lf = logits.float()
        m = lf.amax(dim=-1, keepdim=True)
        lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
        safe = torch.clamp(labels, min=0)
        gold = torch.gather(lf, -1, safe[..., None])[..., 0]
        nll = lse - gold
        mask = (labels != ignore).float()
        return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)


def forward_train(params: Params, cfg: ModelConfig, batch: Dict[str, Any]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training forward: (scalar fp32 loss, metrics {"ce", "aux", "loss"}
    and "mtp" where the config predicts a second token).  The loss is
    ce + 0.3·mtp + the MoE routers' auxiliary loss."""
    h = _constrain(_embed_inputs(params, cfg, batch))
    h, _, aux = _run_stack(params, cfg, h, cache=None, index=None)
    loss = cross_entropy(_logits(params, cfg, h), batch["labels"])
    metrics = {"ce": loss, "aux": aux}
    if cfg.mtp_depth and "tokens" in batch:
        loss_mtp = _mtp_loss(params, cfg, h, batch)
        metrics["mtp"] = loss_mtp
        loss = loss + 0.3 * loss_mtp
    total = loss + aux
    metrics["loss"] = total
    return total, metrics


def _mtp_loss(params: Params, cfg: ModelConfig, h, batch):
    """DeepSeek-V3 multi-token prediction: one extra (dense attention)
    block predicting token t+2 from [h_t ; embed(token_{t+1})]."""
    dt = h.dtype
    emb = params["embed"]["w"].to(dt)[batch["tokens"]]
    nxt = torch.roll(emb, -1, dims=1)
    u = torch.cat([L.rms_norm(h, params["mtp"]["norm"]["w"], cfg.norm_eps),
                   nxt], dim=-1)
    hm = torch.matmul(u, params["mtp"]["proj"]["w"].to(dt))
    hm, _, _ = _apply_layer(hm, params["mtp"]["block"], cfg,
                            LayerKind(mixer="attn"), None, None)
    labels2 = torch.roll(batch["labels"], -1, dims=1)
    labels2[:, -2:] = -1
    return cross_entropy(_logits(params, cfg, hm), labels2)


def serve_step(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
               cache, index) -> Tuple[torch.Tensor, Any]:
    """Prefill (S>1, index=0) or decode (S=1) against a persistent cache
    (or a whole-sequence forward with ``cache=None``, an encoder's only
    mode).  ``batch`` holds "tokens", "frames" or "patches" + "tokens" as
    the config's ``input_kind`` says.
    Returns (logits [B,S,V], new_cache).

    The JAX package returns a new cache and leaves the old one as it was;
    the port writes the blocks' caches in place (an attention layer's
    keys and values straight into the cache, a mixer's new state into its
    slot) and returns ``cache`` itself, so no step copies the cache."""
    h = _embed_inputs(params, cfg, batch)
    h, new_cache, _ = _run_stack(params, cfg, h, cache=cache, index=index)
    return _logits(params, cfg, h), new_cache


__all__ = ["param_specs", "init_params", "set_activation_spec", "cast_params", "cache_specs",
           "init_cache", "apply_block", "serve_step", "cross_entropy",
           "forward_train"]
