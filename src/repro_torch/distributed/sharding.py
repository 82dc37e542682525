"""Logical-axis sharding rules (DP / FSDP / TP / EP / SP) over a
``DeviceMesh`` (the JAX package's ``distributed/sharding.py``).

Every parameter leaf gets a tuple of *logical* dim names derived from
its path (pattern table below); logical names map to prioritized mesh
axes; the first mesh axis, or tuple of axes, that (a) divides the dim and
(b) is not already used by another dim of the same leaf wins.

Defaults:
  tensor-parallel ("model"): vocab, heads/kv_heads/q_per_kv/head,
      mlp hidden, experts (EP), ssm inner channels
  fully-sharded ("data" [+ "pod"]): embed/feature dims of weights (ZeRO-3)
  batch ("pod","data"): activation batch dims
  sequence ("model"): KV-cache length when the batch can't fill the data
      axis (long-context decode SP)

A spec is JAX-shaped: a tuple with one entry per leading tensor dim, each
``None``, a mesh axis name or a tuple of names (one dim split over
several axes, the first outermost), trailing ``None``s dropped — the
entries of the JAX package's ``PartitionSpec``.  ``placements`` turns a
spec into DTensor placements on the mesh.  Leaves are named by their
``keystr`` path (``repro_torch.tree``), so the regexes are the JAX
package's unchanged.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.placement_types import Placement, _StridedShard

from ..tree import map_with_path

Spec = Tuple[Any, ...]

# path-pattern -> logical dim names (matched against keystr of the leaf,
# AFTER the stacked "blocks" leading 'layers' dim is accounted for)
_PATTERNS = [
    (r"embed.*\['w'\]$", ("vocab", "embed")),
    (r"lm_head.*\['w'\]$", ("embed", "vocab")),
    (r"(frame|patch)_proj.*\['w'\]$", ("frontend", "embed")),
    (r"attn'\]\['wq'\]$", ("embed", "kv_heads", "q_per_kv", "head")),
    (r"attn'\]\['wk'\]$", ("embed", "kv_heads", "head")),
    (r"attn'\]\['wv'\]$", ("embed", "kv_heads", "head")),
    (r"attn'\]\['wo'\]$", ("kv_heads", "q_per_kv", "head", "embed")),
    (r"attn'\]\['bq'\]$", ("kv_heads", "q_per_kv", "head")),
    (r"attn'\]\['b[kv]'\]$", ("kv_heads", "head")),
    (r"attn'\]\['wq_a'\]$", ("embed", "lora")),
    (r"attn'\]\['wq_b'\]$", ("lora", "heads", "head")),
    (r"attn'\]\['wkv_a'\]$", ("embed", "lora")),
    (r"attn'\]\['wkv_b'\]$", ("lora", "heads", "head")),
    (r"attn'\]\['wo_mla'\]$", ("heads", "head", "embed")),
    (r"router'\]$", ("embed", "expert")),
    (r"experts'\]\['wi'\]$", ("expert", "embed", "act", "mlp")),
    (r"experts'\]\['wo'\]$", ("expert", "mlp", "embed")),
    (r"ffn'\]\['wi'\]$", ("embed", "act", "mlp")),
    (r"ffn'\]\['wo'\]$", ("mlp", "embed")),
    (r"shared'\]\['wi'\]$", ("embed", "act", "mlp")),
    (r"shared'\]\['wo'\]$", ("mlp", "embed")),
    (r"ssm'\]\['in_proj'\]$", ("embed", "ssm_ch")),
    (r"ssm'\]\['out_proj'\]$", ("ssm_inner", "embed")),
    (r"ssm'\]\['conv_w'\]$", ("conv", "ssm_ch")),
    (r"mtp'\]\['proj'\]\['w'\]$", ("embed2", "embed")),
]

# logical name -> mesh-axis priority list; special names:
#   "fsdp"  resolves to the configured FSDP axes
_DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "vocab": ("model",),
    "kv_heads": ("model",),
    "q_per_kv": ("model",),
    "heads": ("model",),
    "head": ("model",),
    "mlp": ("model",),
    "expert": ("model",),
    "ssm_ch": ("model",),
    "ssm_inner": ("model",),
    "embed": ("fsdp",),
    "embed2": (),
    "frontend": (),
    "lora": ("fsdp",),
    "act": (),
    "conv": (),
}


def logical_axes_for(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    for pat, names in _PATTERNS:
        if re.search(pat, path):
            if len(names) == ndim:
                return names
            if len(names) == ndim - 1:       # stacked block leaf
                return ("layers", *names)
    return tuple([None] * ndim)              # norms, scalars: replicated


def axis_sizes(mesh: DeviceMesh) -> Dict[str, int]:
    """{axis name: size} of a mesh (the JAX ``mesh.shape`` mapping)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, outermost first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _trim(entries: list) -> Spec:
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def placements(spec: Spec, mesh: DeviceMesh) -> Tuple[Placement, ...]:
    """DTensor placements (one per mesh dim) of a JAX-shaped spec.

    A dim split over several axes is ``Shard(d)`` on each of their mesh
    dims.  DTensor splits in mesh-dim order, outermost first, so a tuple
    in mesh order — ``("data", "model")``, the order of ``lax.all_to_all``
    and of JAX's ``NamedSharding`` — gives device (d, m) chunk d·M + m, as
    JAX does.  A pair against mesh order (``("model", "data")``) puts the
    inner axis's split on ``_StridedShard`` so that the chunk order stays
    the spec's; longer tuples against mesh order raise."""
    names = list(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx == sorted(idx):
            for i in idx:
                out[i] = Shard(d)
        elif len(idx) == 2:
            outer, inner = idx
            out[outer] = Shard(d)
            out[inner] = _StridedShard(d, split_factor=sizes[axes[0]])
        else:
            raise NotImplementedError(
                f"dim {d} split over {axes} against the mesh order {names}")
    return tuple(out)


@dataclass(frozen=True)
class Sharding:
    """A spec on a mesh: the port's ``NamedSharding``."""
    mesh: DeviceMesh
    spec: Spec

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """One device's local shape (``NamedSharding.shard_shape``); every
        split must divide its dim."""
        sizes = axis_sizes(self.mesh)
        splits = [math.prod(sizes[a] for a in entry_axes(e))
                  for e in self.spec]
        out = []
        for dim, k in zip(shape, splits + [1] * (len(shape) - len(splits))):
            if dim % k:
                raise ValueError(f"spec {self.spec} does not divide {shape}")
            out.append(dim // k)
        return tuple(out)


class ShardingRules:
    def __init__(self, mesh: DeviceMesh, fsdp_axes: Sequence[str] = ("data",),
                 overrides: Optional[Dict[str, Tuple]] = None,
                 fsdp_min_size: int = 2 ** 16):
        self.mesh = mesh
        self.axis_sizes = axis_sizes(mesh)
        self.fsdp_axes = tuple(a for a in fsdp_axes if a in self.axis_sizes)
        self.rules = dict(_DEFAULT_RULES)
        if overrides:
            self.rules.update(overrides)
        self.fsdp_min_size = fsdp_min_size

    def _resolve(self, logical: Optional[str]) -> Tuple:
        """Returns candidate entries; each candidate is a tuple of mesh
        axes (len > 1 => combined sharding of one dim, e.g. EP over
        model×data)."""
        if logical is None or logical == "layers":
            return ()
        out = []
        for a in self.rules.get(logical, ()):
            if a == "fsdp":
                if self.fsdp_axes:
                    out.append(tuple(self.fsdp_axes))
            elif isinstance(a, tuple):
                out.append(a)
            else:
                out.append((a,))
        return tuple(out)

    def spec_for(self, path: str, shape: Tuple[int, ...]) -> Spec:
        names = logical_axes_for(path, len(shape))
        if math.prod(shape) < self.fsdp_min_size:
            return ()                         # small leaves: replicate
        used: set = set()
        entries = []
        for dim, logical in zip(shape, names):
            chosen = None
            for cand in self._resolve(logical):
                if any(a in used or a not in self.axis_sizes for a in cand):
                    continue
                if dim % math.prod(self.axis_sizes[a] for a in cand) == 0:
                    chosen = cand if len(cand) > 1 else cand[0]
                    used.update(cand)
                    break
            entries.append(chosen)
        return _trim(entries)

    def sharding(self, spec: Spec) -> Sharding:
        return Sharding(self.mesh, tuple(spec))

    # ------------------------------------------------------------------ #
    def param_shardings(self, specs) -> Any:
        """A tree of ``Sharding`` for a tree of ``TensorSpec`` or tensors."""
        return map_with_path(
            lambda path, leaf: self.sharding(
                self.spec_for(path, tuple(leaf.shape))), specs)

    def batch_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in ("pod", "data") if a in self.axis_sizes)

    def _batch_entry(self, nbatch: int):
        """The batch dim's entry: (pod, data) if they divide it, else data
        if it does, else None."""
        baxes = self.batch_axes()
        total = math.prod(self.axis_sizes[a] for a in baxes)
        if baxes and nbatch % total == 0:
            return baxes if len(baxes) > 1 else baxes[0]
        if "data" in self.axis_sizes and \
                nbatch % self.axis_sizes["data"] == 0:
            return "data"
        return None

    def _batch_spec(self, nbatch: int, rest_ndim: int,
                    seq_axis: Optional[int] = None, seq_size: int = 0) -> Spec:
        """Shard batch over (pod,data) if divisible; else fall back to
        sequence-parallel over 'model'."""
        entries: list = [None] * (1 + rest_ndim)
        entries[0] = self._batch_entry(nbatch)
        if entries[0] is None and seq_axis is not None and \
                "model" in self.axis_sizes and \
                seq_size % self.axis_sizes["model"] == 0:
            entries[seq_axis] = "model"
        return _trim(entries)

    def input_shardings(self, batch_specs) -> Any:
        """Sharding for a batch dict (tokens/labels/frames/patches)."""
        return map_with_path(
            lambda path, leaf: self.sharding(
                self._batch_spec(leaf.shape[0], len(leaf.shape) - 1)),
            batch_specs)

    def _cache_spec(self, name: str, shape: Tuple[int, ...]) -> Spec:
        # stacked block caches have a leading n_blocks dim
        b_ax = 1 if "blocks" in name else 0
        entries: list = [None] * len(shape)
        entries[b_ax] = self._batch_entry(shape[b_ax])
        # model axis: heads for k/v, seq for latent, heads for state
        m = self.axis_sizes.get("model", 1)
        if ("'k'" in name or "'v'" in name) and len(shape) >= b_ax + 4:
            if shape[b_ax + 2] % m == 0:
                entries[b_ax + 2] = "model"
            elif shape[b_ax + 1] % m == 0:
                entries[b_ax + 1] = "model"   # sequence-parallel cache
        elif "latent" in name and len(shape) >= b_ax + 3:
            if shape[b_ax + 1] % m == 0:
                entries[b_ax + 1] = "model"
        elif "state" in name and len(shape) >= b_ax + 4:
            if shape[b_ax + 1] % m == 0:
                entries[b_ax + 1] = "model"
        elif "conv" in name and len(shape) >= b_ax + 3:
            if shape[b_ax + 2] % m == 0:
                entries[b_ax + 2] = "model"
        return _trim(entries)

    def cache_shardings(self, cache_specs) -> Any:
        """KV/latent/SSM caches: batch -> data axes; if batch can't fill
        them, sequence (axis 1 of stacked [nb,B,T,...] leaves) -> model
        (SP); SSM state heads -> model."""
        return map_with_path(
            lambda path, leaf: self.sharding(
                self._cache_spec(path, tuple(leaf.shape))), cache_specs)

    def replicated(self) -> Sharding:
        return Sharding(self.mesh, ())


__all__ = ["ShardingRules", "Sharding", "logical_axes_for", "placements",
           "axis_sizes", "entry_axes"]
