"""Multi-pod dry run: for every (arch × shape) cell on the production
meshes, the per-device numbers a roofline needs (the JAX package's
``launch/dryrun.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
      --shape train_4k [--multi-pod] [--all] [--out artifacts/dryrun]

It allocates nothing, compiles nothing and runs on no device.  The mesh
is a ``DeviceMesh`` of 256 or 512 ranks over PyTorch's fake process group
(this process is rank 0; no collective moves a byte), every input is a
``TensorSpec``, and the one run of the program is on fake tensors.  What
each number is — none of them is XLA's:

  argument / output bytes   exact: each leaf's local shard bytes under
                            ``ShardingRules`` (params, caches, batch) and
                            ``opt_sh`` (optimizer state), summed.  The
                            logits are laid out with the batch on the batch
                            axes and the vocabulary on "model".
  flops / bytes accessed    one run of the unsharded program under
                            ``FakeTensorMode`` at one data-parallel shard
                            of the batch (the train step with its optimizer
                            update, or the serve step), divided by the rest
                            of the mesh: the ideal partition.  FLOPs are
                            ``FlopCounterMode``'s (2·m·n·k a matmul, the
                            matmul-class ops only); bytes accessed sum each
                            operator's tensor inputs and outputs (views move
                            nothing).  XLA instead reads the partitioned
                            program, counts elementwise FLOPs too and fuses
                            operators, so it reports fewer bytes.  The CPU
                            attention strategies run here (no flash kernel),
                            so a long prefill counts its masked blocks.
  temp                      ``MemTracker``'s peak of that run above its
                            inputs, divided the same way.
  collectives               a closed form from the placements: FSDP
                            all-gathers (forward, remat forward, backward),
                            gradient reduce-scatters over the FSDP axes and
                            all-reduces over the batch axes a leaf is not
                            sharded on, the EP all-to-alls of the dispatch
                            buffer, and tensor parallelism's activation
                            all-reduces, one a sharded projection a pass.
                            Bytes are each op's result on one device, as
                            the JAX package's ``collective_bytes`` counts.

The stack is a Python loop over the blocks, so every count covers the
whole program (the JAX package corrects XLA's once-counted scan body with
a standalone block; ``--unroll`` only tags the cell here).  A cell whose
fake run raises records ``status: "fail"`` with the operator that raised.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..configs import (ARCH_NAMES, SHAPES, applicable_shapes, get_config,
                       input_specs)
from ..distributed.sharding import (ShardingRules, Sharding, entry_axes,
                                    logical_axes_for)
from ..models import layers as L
from ..models import model as M
from ..models.config import ModelConfig
from ..optim import OptConfig
from ..train.step import train_state_specs, train_step
from ..tree import leaf_paths, map_with_path
from .mesh import make_production_mesh

# hardware constants (NVIDIA H100 SXM data sheet), per card
PEAK_FLOPS = 989e12          # bf16 dense tensor-core rate
HBM_BW = 3.35e12             # bytes/s, HBM3
NVLINK_BW = 900e9            # bytes/s, NVLink 4 per card, both directions

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")

# logical dims that carry tensor parallelism, by leaf name: a projection
# whose contracting dim is split over "model" all-reduces its output in
# the forward pass; one whose output dim is split all-reduces the grad of
# its input in the backward pass
_TP_FORWARD = {"wo": {"kv_heads", "q_per_kv", "head", "mlp", "expert"},
               "wo_mla": {"heads", "head"}, "out_proj": {"ssm_inner"}}
_TP_BACKWARD = {"wq": {"kv_heads", "q_per_kv", "head"},
                "wk": {"kv_heads", "head"}, "wv": {"kv_heads", "head"},
                "wq_b": {"heads", "head"}, "wkv_b": {"heads", "head"},
                "in_proj": {"ssm_ch"}, "wi": {"mlp", "expert"}}


@contextlib.contextmanager
def fake_world(n: int):
    """PyTorch's fake process group of ``n`` ranks for the block (this
    process is rank 0): meshes build and collectives return at once."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake process group; "
                           "destroy the existing one first")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def tree_bytes(specs, shardings) -> int:
    """Σ of each leaf's local shard bytes (one device)."""
    sh = dict(leaf_paths(shardings))
    return sum(_nbytes(sh[p].shard_shape(s.shape), s.dtype)
               for p, s in leaf_paths(specs))


def build_cell(cfg: ModelConfig, shape_name: str, mesh,
               fsdp_axes=("data",), rule_overrides=None,
               journal: bool = False, moe_ep: bool = False,
               act_constraint: bool = False):
    """Returns (fn, args, in_shardings, out_shardings, donate) for one
    cell: ``fn`` runs the cell's program on tensors shaped as ``args``
    (``TensorSpec`` trees, global shapes)."""
    if moe_ep:
        L.set_moe_ep(mesh, ("data", "model"))
        rule_overrides = dict(rule_overrides or {},
                              expert=((("data", "model"),)))
    if act_constraint:
        baxes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
        M.set_activation_spec((baxes, None, None))
    rules = ShardingRules(mesh, fsdp_axes=fsdp_axes,
                          overrides=rule_overrides)
    cell = input_specs(cfg, SHAPES[shape_name])
    if cell["kind"] == "train":
        opt_cfg = OptConfig(
            name="adafactor" if cfg.param_count() > 30e9 else "adamw")
        state_specs = train_state_specs(cfg, opt_cfg)
        param_sh = rules.param_shardings(state_specs["params"])
        # optimizer leaves inherit the param leaf's spec: m/v are
        # same-shape; adafactor vr drops the last dim, vc the
        # second-to-last.  A derived split that no longer divides the
        # (reduced) shape is dropped.
        pspec = {p: s.spec for p, s in leaf_paths(param_sh)}
        sizes = rules.axis_sizes

        def opt_sh(path, leaf):
            base = pspec.get(re.sub(r"\['(m|v|vr|vc)'\]$", "", path))
            if base is None:
                return rules.replicated()
            if not base and len(leaf.shape) >= 2 and "data" in sizes and \
                    leaf.shape[0] % sizes["data"] == 0 and \
                    math.prod(leaf.shape) >= 2 ** 16:
                # ZeRO-1: params replicated, optimizer state sharded
                return rules.sharding(("data",))
            factored = path.endswith(("['vr']", "['vc']"))
            n = len(leaf.shape) + (1 if factored else 0)  # param ndim
            ent = list(base) + [None] * (n - len(base))
            if path.endswith("['vr']"):
                ent = ent[: n - 1]                  # param dim -1 dropped
            elif path.endswith("['vc']"):
                ent = ent[: n - 2] + [ent[n - 1]]   # param dim -2 dropped
            for i, (dim, e) in enumerate(zip(leaf.shape, ent)):
                if e is not None and \
                        dim % math.prod(sizes[a] for a in entry_axes(e)):
                    ent[i] = None
            while ent and ent[-1] is None:
                ent.pop()
            return rules.sharding(tuple(ent))

        state_sh = {"params": param_sh,
                    "opt": map_with_path(opt_sh, state_specs["opt"]),
                    "step": rules.replicated()}
        batch_sh = rules.input_shardings(cell["batch"])

        def fn(state, batch):
            return train_step(state, batch, cfg, opt_cfg, journal=journal,
                              donate=True)
        return (fn, (state_specs, cell["batch"]), (state_sh, batch_sh),
                (state_sh, None), (0,))

    # serve cell
    pspecs = M.param_specs(cfg)
    param_sh = rules.param_shardings(pspecs)
    batch_sh = rules.input_shardings(cell["batch"])
    if cell["cache"] is not None:
        cache_sh = rules.cache_shardings(cell["cache"])

        def fn(params, batch, cache, index):
            return M.serve_step(params, cfg, batch, cache, index)
        args = (pspecs, cell["batch"], cell["cache"], cell["index"])
        in_sh = (param_sh, batch_sh, cache_sh, rules.replicated())
        return fn, args, in_sh, (None, cache_sh), (2,)

    def fn(params, batch):                  # encoder prefill: no cache
        return M.serve_step(params, cfg, batch, None, None)
    return fn, (pspecs, cell["batch"]), (param_sh, batch_sh), None, ()


# ---------------------------------------------------------------------- #
# the fake run
# ---------------------------------------------------------------------- #

class _OpBytes(TorchDispatchMode):
    """Σ of every operator's tensor inputs and outputs in bytes (views and
    ``prim`` metadata queries such as ``prim.device`` excluded: they move
    no data, and autograd asks a tensor's device tens of thousands of
    times a step), and the last operator dispatched (named when a run
    fails)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.last_op = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "prim":
            return func(*args, **(kwargs or {}))
        self.last_op = str(func)
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size() for t in
                              tree_flatten((args, kwargs, out))[0]
                              if isinstance(t, torch.Tensor))
        return out


def _materialize(specs):
    """Empty tensors (fake, under the caller's FakeTensorMode) for a tree of
    TensorSpec; token and label leaves as int64, as the data pipeline
    gives them."""
    def make(path, s):
        dt = torch.int64 if s.dtype == torch.int32 and s.shape else s.dtype
        return torch.zeros(s.shape, dtype=dt)
    return map_with_path(make, specs)


def fake_run(fn, local_args):
    """Run ``fn`` once on fake tensors shaped as ``local_args``; returns
    {flops, bytes_accessed, temp, outputs} or raises with the failing
    operator in the message."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    ep = L._EP_STATE
    L.set_moe_ep(None, None)                 # the unsharded program
    ops = _OpBytes()
    try:
        with FakeTensorMode(allow_non_fake_inputs=False):
            # the serve step's write index stays a Python int
            args = [a if isinstance(a, int) else _materialize(a)
                    for a in local_args]
            flops = FlopCounterMode(display=False)
            mem = MemTracker()
            with flops, mem, ops:
                out = fn(*args)
            peak = max(v.get("Total", 0) for v in
                       mem.get_tracker_snapshot("peak").values())
            outputs = [(tuple(t.shape), t.dtype)
                       for t in tree_flatten(out)[0]
                       if isinstance(t, torch.Tensor)]
    except Exception as e:
        raise RuntimeError(f"{ops.last_op}: {type(e).__name__}: {e}") from e
    finally:
        L._EP_STATE = ep
    return {"flops": flops.get_total_flops(), "bytes_accessed": ops.bytes,
            "temp": peak, "outputs": outputs}


# ---------------------------------------------------------------------- #
# the collective account
# ---------------------------------------------------------------------- #

def _split_on_model(path: str, ndim: int, sh: Sharding, names) -> bool:
    """Whether a leaf splits one of the logical dims ``names`` over
    "model"."""
    return any(n in names and "model" in entry_axes(e)
               for n, e in zip(logical_axes_for(path, ndim), sh.spec))


def _modules(pspecs, param_sh):
    """{module path: [(leaf name, path, ndim, sharding)]}: the leaves of
    each module (the dict that holds them)."""
    specs = dict(leaf_paths(pspecs))
    mods: Dict[str, list] = {}
    for path, sh in leaf_paths(param_sh):
        mod, leaf = path.rsplit("[", 1)
        mods.setdefault(mod, []).append((leaf[1:-2], path,
                                         len(specs[path].shape), sh))
    return mods


def ep_dispatch_bytes(cfg: ModelConfig, batch: int, seq: int,
                      sizes: Dict[str, int]) -> int:
    """One rank's EP dispatch buffer [R, E/R·C, D] in bytes, C from its
    [B/data, S/model] tokens."""
    t_loc = (batch // sizes["data"]) * (seq // sizes["model"])
    C = max(1, int(math.ceil(t_loc * cfg.experts_per_token / cfg.n_experts
                             * cfg.capacity_factor)))
    return cfg.n_experts * C * cfg.d_model * \
        L.torch_dtype(cfg.compute_dtype).itemsize


def collective_account(cfg: ModelConfig, kind: str, rules: ShardingRules,
                       pspecs, param_sh, tokens_local, global_tokens,
                       moe_ep: bool = False) -> Dict[str, Any]:
    """Per-device collective bytes of one step, by op, and their count.
    ``tokens_local`` = (B, S) of one device's activations, ``global_tokens``
    the cell's (B, S).

    Per param leaf: an FSDP leaf is all-gathered (its local bytes × the
    FSDP split) once a forward pass — twice in a train step, three times
    for a block leaf under block remat — and its grad reduce-scattered; a
    train step all-reduces a leaf's grad over the batch axes the leaf is
    not split on.  Per module of each layer (a block's once a block): a
    projection whose contracting dim is split on "model" all-reduces its
    [B, S, D] output each forward pass (with remat twice), one whose
    output dim is split all-reduces its input's grad in the backward pass
    (the embedding and the LM head count as such projections over the
    vocabulary).  Under EP an experts module instead sends its dispatch
    buffer through two all-to-alls a pass (forward, remat, backward),
    where ``moe_ffn`` would take the EP path."""
    out: Dict[str, Any] = {k: 0 for k in COLLECTIVE_OPS}
    out["count"] = 0

    def add(op, nbytes, times):
        out[op] += nbytes * times
        out["count"] += times

    train = kind == "train"
    remat = train and cfg.remat == "block"
    sizes = rules.axis_sizes
    fsdp = set(rules.fsdp_axes)
    specs = dict(leaf_paths(pspecs))
    for path, sh in leaf_paths(param_sh):
        s = specs[path]
        local = _nbytes(sh.shard_shape(s.shape), s.dtype)
        used = {a for e in sh.spec for a in entry_axes(e)}
        g = math.prod(sizes[a] for a in used & fsdp)
        if g > 1:
            block = path.startswith("['blocks']")
            add("all-gather", local * g,
                2 + int(remat and block) if train else 1)
            if train:
                add("reduce-scatter", local, 1)
        if train and math.prod(sizes[a] for a in rules.batch_axes()
                               if a not in used) > 1:
            add("all-reduce", local, 1)

    # EP where moe_ffn would take it (_moe_ep_applicable's rule)
    B, S = global_tokens
    ep = moe_ep and {"data", "model"} <= sizes.keys() and \
        B % sizes["data"] == 0 and S % sizes["model"] == 0 and \
        cfg.n_experts % (sizes["data"] * sizes["model"]) == 0
    act = math.prod(tokens_local) * cfg.d_model * \
        L.torch_dtype(cfg.compute_dtype).itemsize
    forward_names = dict(_TP_FORWARD, w={"vocab"})      # the embedding
    backward_names = dict(_TP_BACKWARD)
    for mod, leaves in _modules(pspecs, param_sh).items():
        block = mod.startswith("['blocks']")
        times = cfg.n_blocks if block else 1
        passes = 1 + int(remat and block)
        if ep and mod.endswith("['experts']"):
            nb = ep_dispatch_bytes(cfg, *global_tokens, sizes)
            add("all-to-all", nb, 2 * (passes + int(train)) * times)
            continue
        fwd = bwd = False
        for leaf, path, ndim, sh in leaves:
            if mod == "['lm_head']":
                bwd |= _split_on_model(path, ndim, sh, {"vocab"})
                continue
            if leaf in forward_names and (leaf != "w" or mod == "['embed']"):
                fwd |= _split_on_model(path, ndim, sh, forward_names[leaf])
            if leaf in backward_names:
                bwd |= _split_on_model(path, ndim, sh, backward_names[leaf])
        if fwd:
            add("all-reduce", act, passes * times)
        if bwd and train:
            add("all-reduce", act, times)
    return out


# ---------------------------------------------------------------------- #
# one cell
# ---------------------------------------------------------------------- #

def _local_tokens(cell, batch_sh) -> tuple:
    """(B, S) of one device's activations: the batch's local rows and the
    sequence (every non-label input's length together)."""
    key = next(k for k in cell["batch"] if k != "labels")
    spec = cell["batch"][key]
    B = batch_sh[key].shard_shape(spec.shape)[0]
    S = sum(v.shape[1] for k, v in cell["batch"].items() if k != "labels")
    return B, S


def _logits_bytes(rules: ShardingRules, shape, dtype) -> int:
    """The logits laid out with the batch on the batch axes and the
    vocabulary on "model"."""
    vocab = "model" if shape[-1] % rules.axis_sizes.get("model", 1) == 0 \
        and "model" in rules.axis_sizes else None
    sh = rules.sharding((rules._batch_entry(shape[0]), None, vocab))
    return _nbytes(sh.shard_shape(shape), dtype)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Optional[str] = None,
             fsdp_axes=("data",), quiet: bool = False,
             unroll: bool = False,
             cfg_overrides: Optional[Dict[str, Any]] = None,
             rule_overrides: Optional[Dict[str, tuple]] = None,
             journal: bool = False, moe_ep: bool = False,
             act_constraint: bool = False,
             variant: str = "") -> Dict[str, Any]:
    cfg = get_config(arch)
    if unroll:
        cfg = dataclasses.replace(cfg, scan_unroll=True)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    n_dev = 512 if multi_pod else 256
    with fake_world(n_dev):
        return _run_cell(cfg, arch, shape_name, multi_pod, out_dir,
                         fsdp_axes, quiet, unroll, rule_overrides, journal,
                         moe_ep, act_constraint, variant)


def _run_cell(cfg, arch, shape_name, multi_pod, out_dir, fsdp_axes, quiet,
              unroll, rule_overrides, journal, moe_ep, act_constraint,
              variant) -> Dict[str, Any]:
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    n_dev = mesh.size()
    mesh_name = "x".join(str(s) for s in mesh.shape)
    tag = f"{arch}__{shape_name}__{mesh_name}" + ("__unroll" if unroll
                                                  else "")
    if variant:
        tag += f"__{variant}"
    if shape_name not in applicable_shapes(cfg):
        return {"cell": tag, "status": "skip",
                "reason": "shape not applicable (DESIGN.md §4)"}
    t0 = time.time()
    try:
        fn, args, in_sh, out_sh, donate = build_cell(
            cfg, shape_name, mesh, fsdp_axes, rule_overrides=rule_overrides,
            journal=journal, moe_ep=moe_ep, act_constraint=act_constraint)
        if moe_ep:
            rule_overrides = dict(rule_overrides or {},
                                  expert=((("data", "model"),)))
        rules = ShardingRules(mesh, fsdp_axes=fsdp_axes,
                              overrides=rule_overrides)
        shape = SHAPES[shape_name]
        cell = input_specs(cfg, shape)
        kind = cell["kind"]
        batch_sh = in_sh[1]
        tokens = _local_tokens(cell, batch_sh)
        # one data-parallel shard of the batch; the rest of the mesh
        # divides its work (the ideal partition)
        divisor = n_dev * tokens[0] // shape.global_batch
        local = input_specs(cfg, shape, per_pod_batch=tokens[0])
        arg_bytes = sum(tree_bytes(a, s) for a, s in zip(args, in_sh))
        if kind == "train":
            state = args[0]
            local_args = (state, local["batch"])
            params, param_sh = state["params"], in_sh[0]["params"]
        elif local["cache"] is not None:
            index = 0 if shape.kind == "prefill" else shape.seq_len - 1
            local_args = (args[0], local["batch"], local["cache"], index)
            params, param_sh = args[0], in_sh[0]
        else:
            local_args = (args[0], local["batch"])
            params, param_sh = args[0], in_sh[0]
        t_build = time.time() - t0
        t0 = time.time()
        run = fake_run(fn, local_args)
        t_run = time.time() - t0
        coll = collective_account(
            cfg, kind, rules, params, param_sh, tokens,
            (shape.global_batch, tokens[1]), moe_ep=moe_ep)
    except Exception as e:                  # reported, never replicated
        result = {"cell": tag, "status": "fail", "arch": arch,
                  "shape": shape_name, "mesh": mesh_name,
                  "error": f"{type(e).__name__}: {e}"}
        if not quiet:
            print(f"[dryrun] {tag}: FAIL {result['error']}")
        _write(out_dir, tag, result)
        return result
    finally:
        if moe_ep:
            L.set_moe_ep(None, None)
        if act_constraint:
            M.set_activation_spec(None)

    if kind == "train":                     # (new state, metrics)
        metrics = run["outputs"][sum(1 for _ in leaf_paths(args[0])):]
        out_bytes = tree_bytes(args[0], in_sh[0]) + \
            sum(_nbytes(s, d) for s, d in metrics)
    else:
        logits_shape, logits_dt = run["outputs"][0]
        out_bytes = _logits_bytes(
            rules, (shape.global_batch, *logits_shape[1:]), logits_dt)
        if out_sh is not None:
            out_bytes += tree_bytes(args[2], out_sh[1])
    result = {
        "cell": tag, "status": "ok", "arch": arch, "shape": shape_name,
        "mesh": mesh_name, "n_devices": n_dev,
        "build_s": round(t_build, 2), "fake_run_s": round(t_run, 2),
        "partition": divisor,
        "flops_per_device": run["flops"] / divisor,
        "bytes_accessed_per_device": run["bytes_accessed"] / divisor,
        "collective_bytes_per_device": coll,
        "memory_analysis": {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": run["temp"] / divisor,
        },
        "model_params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    if not quiet:
        coll_total = sum(v for k, v in coll.items() if k != "count")
        print(f"[dryrun] {tag}: fake run {t_run:.1f}s, "
              f"flops/dev={result['flops_per_device']:.3e}, "
              f"coll={coll_total:.3e}B ({coll['count']} ops)")
        print(f"  memory_analysis: {result['memory_analysis']}")
    _write(out_dir, tag, result)
    return result


def _write(out_dir: Optional[str], tag: str, result: Dict[str, Any]) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(result, f, indent=1)


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_NAMES + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch × applicable shape) cell")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--fsdp-pods", action="store_true",
                    help="extend FSDP over the pod axis")
    ap.add_argument("--unroll", action="store_true",
                    help="tag the cell as unrolled (the port's counts are "
                         "whole-program either way)")
    args = ap.parse_args(argv)

    fsdp = ("pod", "data") if args.fsdp_pods else ("data",)
    if args.all:
        cells = [(arch, shape) for arch in ARCH_NAMES
                 for shape in ["train_4k", "prefill_32k", "decode_32k",
                               "long_500k"]]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    failures = 0
    for arch, shape in cells:
        try:
            r = run_cell(arch, shape, args.multi_pod, args.out, fsdp,
                         unroll=args.unroll)
        except Exception as e:
            failures += 1
            print(f"[dryrun] {arch}/{shape}: FAIL {type(e).__name__}: {e}")
            traceback.print_exc()
            continue
        if r["status"] == "skip":
            print(f"[dryrun] {r['cell']}: SKIP ({r['reason']})")
        failures += r["status"] == "fail"
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
