"""The train driver: a closed loop of the port's ``Trainer.run``.

Set-up builds one trainer over the configuration's deployment (the
replicated log as journal and manifest store, the replicated object
stores), with the benchmark's weights from the seed and zero moments, and
``Trainer.step_fn`` bound to the port's ``train_step(journal=True,
donate=True)``.  The same trainer runs the first ``follow`` steps — which
the reference follows once the window has closed — then warm-up steps,
then the measured window: ``Trainer.run`` of as many steps as fill
``--seconds`` at the warm-up's pace (where the mix checkpoints, the whole
checkpoint cycles that fit, at least one), its drain of the journal and
of the last save included.

Every step, the checked ones and the window's, is the one call
``Trainer.step_fn``.  While the first steps run, and in one step after
the window has closed, the port's ``tree_checksums`` (the integrity record
the journaled step computes) is wrapped, so that the grads it is given are
hashed by the plain hash beside the record the step returns; the time that
takes is not counted as set-up.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from ..harness import deploy, roofline, trace, traffic, weights
from ..harness.main import Context, Outcome, limits
from ..reference import hash as ref_hash
from ..reference import logread
from ..reference import model as ref_model
from ..reference import train as ref_train


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Step:
    """``Trainer.step_fn``: ``fn``, the port's journaled, donated train
    step, under the harness's span; while ``keep`` is set, the integrity
    record each step returns is kept."""

    def __init__(self, fn, trace_on: bool):
        self.fn, self.trace_on = fn, trace_on
        self.keep = False
        self.integrity: List[List[int]] = []
        self.tw = None
        self.calls = 0
        self.window_start = None

    def __call__(self, state, batch):
        if self.tw is not None:
            self.tw.unit(self.calls - self.window_start)
        self.calls += 1
        with trace.span("step", self.trace_on):
            new, met = self.fn(state, batch)
        if self.keep:
            got = met.get("integrity")
            self.integrity.append([] if got is None else got.tolist())
        return new, met


class PlainHashes:
    """While entered, each call of the port's ``tree_checksums`` also
    hashes the tree it is given with the plain hash (``want``)."""

    def __init__(self, device):
        from repro_torch.kernels.checksum import ops
        self.ops, self.device = ops, device
        self.orig = ops.tree_checksums
        self.want: List[List[int]] = []
        self.seconds = 0.0

    def __enter__(self):
        self.ops.tree_checksums = self
        return self

    def __exit__(self, *exc):
        self.ops.tree_checksums = self.orig

    def __call__(self, tree):
        out = self.orig(tree)
        _sync(self.device)
        t = time.perf_counter()
        self.want.append(ref_hash.tree_hashes(_leaves(tree)))
        self.seconds += time.perf_counter() - t
        return out


class Timed:
    """A call into the program timed on the host (and a harness span in
    a traced run); with ``keep``, each call's arguments' state is kept
    as a device copy (the newest checkpoint's, for the restore check)."""

    def __init__(self, fn, name: str, trace_on: bool, keep: bool = False):
        self.fn, self.name, self.trace_on, self.keep = fn, name, trace_on, keep
        self.ms: List[float] = []
        self.done_s: List[float] = []
        self.on = False
        self.kept = None

    def __call__(self, *a, **kw):
        if self.keep:
            self.kept = (a[0], {n: t.detach().clone() for n, t in
                                _leaves(a[1])})
        t = time.perf_counter()
        with trace.span(self.name, self.trace_on):
            r = self.fn(*a, **kw)
        end = time.perf_counter()
        if self.on:
            self.ms.append((end - t) * 1e3)
            if hasattr(r, "add_done_callback"):
                r.add_done_callback(
                    lambda _f, end=end: self.done_s.append(
                        time.perf_counter() - end))
        return r


def _leaves(tree):
    from repro_torch.tree import leaf_paths
    return [(n, t) for n, t in leaf_paths(tree)
            if isinstance(t, torch.Tensor)]


def _norms(ts: Dict[str, torch.Tensor], div: float = 1.0) -> Dict[str, float]:
    return {n: float(t.float().norm()) / div for n, t in ts.items()}


def run(ctx: Context) -> Outcome:
    from repro_torch.launch.train import check_trainable
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.train.step import train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import leaf_paths

    dev = ctx.device
    conf, mix, own = ctx.cell.config, ctx.cell.traffic, ctx.cell.settings
    dep = conf["deployment"]
    cfg = deploy.model_config(conf, ctx.overrides)
    model = {**conf["model"], **ctx.overrides}
    B, S = mix["batch"], mix["seq_len"]
    check_trainable(cfg, dev, S)
    opt = OptConfig(**dep["optimizer"])
    specs = weights.port_specs(cfg)
    every = int(mix.get("ckpt_every") or 0)
    tc = dep["trainer"]

    d = deploy.Deployment(conf, dev)
    data = traffic.SyntheticDataset(
        cfg, traffic.DataConfig(seed=ctx.seed, batch=B, seq_len=S))
    tr = Trainer(cfg, opt, data, d.mgr, TrainerConfig(
        total_steps=1 << 40, ckpt_every=every or (1 << 40),
        journal_freq=tc["journal_freq"], journal_every=tc["journal_every"],
        seed=ctx.seed, async_ckpt=tc["async_ckpt"]), device=dev)
    params = weights.as_tree(weights.make(specs, ctx.seed, dev), cfg)
    tr.state = {"params": params, "opt": init_opt_state(params, opt),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}
    del params

    def port_step(state, batch):
        return train_step(state, batch, cfg, opt, journal=True, donate=True)
    step = Step(ctx.plant(port_step) if ctx.plant else port_step, ctx.trace)
    tr.step_fn = step
    hashes = PlainHashes(dev)
    journal = Timed(d.mgr.journal, "journal", ctx.trace)
    d.mgr.journal = journal
    save = Timed(d.mgr.save_async, "save_async", ctx.trace, keep=every > 0)
    d.mgr.save_async = save
    if ctx.trace:
        fetch = data.tensors_at

        def tensors_at(s, device):
            with trace.span("data", True):
                return fetch(s, device)
        data.tensors_at = tensors_at

    built = time.time() - ctx.t0
    # the first steps, which the reference follows
    follow = int(own["check"]["follow_steps"])
    step.keep = True
    with hashes:
        tr.run(1)
        _sync(dev)
        t = time.perf_counter()
        moments = _opt_leaves(tr.state["opt"])
        first = _norms({n: s["m"] for n, s in moments}, 1 - opt.b1)
        # the first clipped gradient as the optimizer got it, for the
        # reference to judge
        first_grads = {n: s["m"].cpu() / (1 - opt.b1) for n, s in moments}
        del moments
        check_s = time.perf_counter() - t
        tr.run(follow - 1)
    step.keep = False
    _sync(dev)
    t = time.perf_counter()
    now = dict(leaf_paths(tr.state["params"]))
    change = {n: _gap_norm(now[n], p0)
              for n, p0 in weights.leaves(specs, ctx.seed, dev)}
    del now
    check_s += time.perf_counter() - t + hashes.seconds

    followed = time.time() - ctx.t0
    # warm-up at the window's pace
    warm = int(mix.get("warmup_steps", 2))
    _sync(dev)
    t = time.perf_counter()
    tr.run(warm)
    _sync(dev)
    pace = (time.perf_counter() - t) / warm
    n = max(1, round(ctx.seconds / pace))
    if every:
        n = every * max(1, n // every)
    tw = trace.TraceWindow(ctx.trace, int(own["trace"]["skip"]),
                           int(own["trace"]["units"]))
    n = max(n, tw.units_needed())
    step.tw, step.window_start = tw, step.calls
    journal.on = save.on = True
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _sync(dev)
    setup_s = time.time() - ctx.t0 - check_s
    ctx.log(f"set-up {setup_s:.3f} s (+ {check_s:.3f} s of checks; "
            f"built at {built:.3f} s, first steps done at {followed:.3f} s); "
            f"pace {pace * 1e3:.3f} ms a step -> window of {n} steps")

    w0 = time.perf_counter()
    tr.run(n)
    _sync(dev)
    elapsed = time.perf_counter() - w0
    tw.finish()
    journal.on = save.on = False
    rate = n * B * S / elapsed
    peak = torch.cuda.max_memory_allocated() \
        if torch.device(dev).type == "cuda" else 0
    losses = list(tr.report.losses)
    ctx.log(f"window {elapsed:.3f} s, {n} steps, {rate:.3f} tokens/s; "
            f"losses {losses[0]:.5f} .. {losses[-1]:.5f}; "
            f"saves {tr.report.ckpts_saved} skipped {tr.report.ckpts_skipped};"
            f" peak {peak / 1e9:.3f} GB")

    summary = tw.summary(ctx.log) if ctx.trace else None
    step.tw = None

    # one more step on the state the window left, its grads hashed
    # plainly as the first steps' were
    step.keep = True
    with hashes:
        tr.run(1)
    step.keep = False
    losses = list(tr.report.losses)

    # what the window produced, read back
    records = [{"step": s, "loss": v} for s, v in enumerate(losses)]
    journal_bad = logread.missing(d.images(), records)
    hash_bad = sum(int(a != b) for got, want in
                   zip(step.integrity, hashes.want)
                   for a, b in zip(got, want))
    hash_bad += sum(abs(len(got) - len(want)) for got, want in
                    zip(step.integrity, hashes.want))
    hash_bad += abs(len(hashes.want) - (follow + 1)) + \
        abs(len(step.integrity) - (follow + 1))
    restore_bad = None
    if every:
        restore_bad = _restore_check(tr, d, save)
    n_leaves = len(specs)
    nonfinite = sum(1 for v in losses if v != v or abs(v) == float("inf"))

    prog = {"losses": losses[:follow], "first_grad": first,
            "change": change}
    tr.state = None
    save.kept = None
    d.close()
    del tr
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()

    # the reference follows the first steps
    t = time.perf_counter()
    batches = [data.tensors_at(s, dev) for s in range(follow)]
    want = ref_train.follow(lambda: weights.make(specs, ctx.seed, dev),
                            model, batches, dep["optimizer"], ref_model.Ops(),
                            int(own["check"].get("rows", 1)),
                            judge=first_grads)
    del first_grads
    g = ref_train.gaps(prog, want)
    ctx.log(f"reference {time.perf_counter() - t:.3f} s; losses program "
            f"{prog['losses']} reference {want['losses']}; grad_err "
            f"{g['grad_err']!r}; worst leaves: grad {g['grad_gap_leaf']} "
            f"err {g['grad_err_leaf']} change {g['change_gap_leaf']}; left "
            f"out of the change: {g['null_leaves']}")

    lim = limits(ctx.cell)
    # the numbers the cell's file gives a limit
    checks = [(k, g[k], lim[k]) for k in
              ("loss_gap", "grad_gap", "grad_err", "change_gap") if k in lim]
    checks += [("hash_bad", hash_bad, lim["hash_bad"]),
               ("journal_bad", journal_bad, lim["journal_bad"])]
    if restore_bad is not None:
        checks.append(("restore_bad", restore_bad, lim["restore_bad"]))

    readings = {"kind": "train", "tokens_per_s": rate, "steps": n,
                "flops_per_token": roofline.train_flops_per_token(model, S),
                "journal_ms": journal.ms, "save_stall_ms": save.ms,
                "save_s": save.done_s}
    if summary is not None:
        readings.update(_trace_readings(summary, model, B, S, cfg, specs,
                                        n_leaves))
    return Outcome(e2e={ctx.cell.settings["rate_metric"]: rate,
                        "setup_s": setup_s},
                   attempted=n, failed=nonfinite, checks=checks,
                   readings=readings, summary=summary,
                   memory_peak_bytes=int(peak))


def _gap_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| in float32, a slice of the leading axis at a time."""
    total = 0.0
    for x, y in zip(a.reshape(a.shape[0] if a.dim() else 1, -1),
                    b.reshape(b.shape[0] if b.dim() else 1, -1)):
        total += float((x.float() - y.float()).double().pow(2).sum())
    return total ** 0.5


def _opt_leaves(opt_tree):
    """(param name, {"m", "v"}) of the AdamW state tree."""
    out = []

    def walk(node, prefix):
        if isinstance(node, dict) and set(node) == {"m", "v"} and \
                isinstance(node["m"], torch.Tensor):
            out.append((prefix, node))
            return
        for k in sorted(node):
            walk(node[k], f"{prefix}[{k!r}]")
    walk(opt_tree, "")
    return out


def _restore_check(tr, d, save) -> int:
    """The newest committed checkpoint restored through the log and the
    stores, against the device copy of the state it was taken from: the
    number of leaves that differ in any byte (or are missing)."""
    from repro_torch.tree import map_with_path
    if save.kept is None:
        return 1
    kept_step, kept = save.kept
    template = map_with_path(lambda n, t: torch.empty_like(t)
                             if isinstance(t, torch.Tensor) else t,
                             tr.state)
    step, restored, _ = d.mgr.restore(template)
    got = dict(_leaves(restored))
    bad = int(step != kept_step)
    for n, want in kept.items():
        have = got.get(n)
        if have is None or have.shape != want.shape or \
                have.dtype != want.dtype or not torch.equal(
                    have.reshape(-1).view(torch.uint8),
                    want.reshape(-1).view(torch.uint8)):
            bad += 1
    return bad


def _trace_readings(s, model: dict, B: int, S: int, cfg, specs,
                    n_leaves: int) -> dict:
    """The traced try's kernel times beside the least times of the work
    its counters say it launched."""
    dt = cfg.compute_dtype
    bound = {}
    if model["family"] == "ssm":
        di = model["ssm_expand"] * model["d_model"]
        shape = (B, S, di // model["ssm_head_dim"], model["ssm_head_dim"],
                 model["ssm_n_groups"], model["ssm_state_dim"],
                 model["ssm_chunk"])
        bound["ssd_fwd"] = s.calls["ssd_fwd"] * roofline.ssd_bound_ms(shape,
                                                                      dt)
        bound["ssd_bwd"] = s.calls["ssd_bwd"] * \
            roofline.ssd_bwd_bound_ms(shape, dt)
    else:
        hd = model.get("head_dim") or model["d_model"] // model["n_heads"]
        shape = (B, model["n_heads"], model["n_kv_heads"], S, hd)
        bound["flash_fwd"] = s.calls["flash_fwd"] * \
            roofline.flash_bound_ms(shape, True, None, dt)
        bound["flash_bwd"] = s.calls["flash_bwd"] * \
            roofline.flash_bwd_bound_ms(shape, True, None, dt)
    per_step = sum(roofline.bound_ms(1, -(-_nbytes(sh, dty) // 4))
                   for _, sh, dty in specs)
    bound["hash"] = s.calls["hash"] / n_leaves * per_step
    return {"busy_s": s.busy_s, "window_s": s.window_s,
            "kernel_ms": s.kernel_ms, "bound_ms": bound,
            "tokens_per_s": (s.last - s.first) * B * S / s.window_s}


def _nbytes(shape, dtype) -> int:
    n = 1
    for v in shape:
        n *= v
    return n * torch.empty((), dtype=dtype).element_size()
