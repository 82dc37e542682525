"""The prefill driver: a closed loop of the port's ``launch/serve.generate``
over params restored from a checkpoint committed through the log.

Set-up draws the weights from the seed, commits them as a checkpoint
through the configuration's deployment (the replicated log and the
replicated stores, a synchronous save), restores them through the log
into fresh tensors (checked byte for byte against the weights), casts
them for serving as the port serves (``cast_params``), and warms up one
cycle of the mix (every prompt length once, after one batch that builds
the kernels).  The window is a whole number of cycles, each batch
``generate(params, cfg, prompts, gen)`` on the next prompt length of the
seed's order.

Once the window has closed, a sample of its batches, drawn from the seed
with the longest prompt length in it, is run through the plain float32
forward: each served token's logit is held to the reference's best at its
position.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ..harness import deploy, roofline, trace, traffic, weights
from ..harness.main import Context, Outcome, limits
from ..reference import serve as ref_serve


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(ctx: Context) -> Outcome:
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.tree import leaf_paths, map_with_path

    dev = ctx.device
    conf, mix, own = ctx.cell.config, ctx.cell.traffic, ctx.cell.settings
    cfg = deploy.model_config(conf, ctx.overrides)
    model = {**conf["model"], **ctx.overrides}
    B, gen, lengths = mix["batch"], int(mix["gen"]), list(mix["lengths"])
    for L in lengths:
        serve.check_servable(cfg, L)
    specs = weights.port_specs(cfg)
    V = model["vocab_size"]

    # the weights committed through the log and restored from it
    d = deploy.Deployment(conf, dev)
    try:
        params = weights.as_tree(weights.make(specs, ctx.seed, dev), cfg)
        d.mgr.save(0, params, extra={"seed": ctx.seed}, sync=True)
        template = map_with_path(lambda n, t: torch.empty_like(t), params)
        step, restored, _ = d.mgr.restore(template)
        del template
        _sync(dev)
        t = time.perf_counter()
        want = dict(leaf_paths(params))
        restore_bad = int(step != 0) + sum(
            int(not torch.equal(t_.reshape(-1).view(torch.uint8),
                                want[n].reshape(-1).view(torch.uint8)))
            for n, t_ in leaf_paths(restored))
        check_s = time.perf_counter() - t
        del params, want
    finally:
        d.close()
    served = M.cast_params(restored, cfg)
    del restored

    def serve_tokens(p):
        return serve.generate(served, cfg, p, gen).tokens
    if ctx.plant:
        serve_tokens = ctx.plant(serve_tokens)

    def batch(i: int, length: int):
        p = traffic.prompts(ctx.seed, i, B, length, V, dev)
        with trace.span("generate", ctx.trace):
            return serve_tokens(p)

    # warm-up: one batch that builds the kernels on a checkout's first
    # run, then one cycle, every length once, at the window's pace
    per_cycle = len(lengths)
    batch(1 << 31, min(lengths))
    _sync(dev)
    t = time.perf_counter()
    for j, L in enumerate(traffic.prompt_plan(lengths, 1, ctx.seed)):
        batch((1 << 30) + j, L)
    _sync(dev)
    pace = time.perf_counter() - t
    cycles = max(1, round(ctx.seconds / pace))
    tw = trace.TraceWindow(ctx.trace, int(own["trace"]["skip"]),
                           int(own["trace"]["units"]))
    cycles = max(cycles, -(-tw.units_needed() // per_cycle))
    plan = traffic.prompt_plan(lengths, cycles + 1, ctx.seed)[per_cycle:]
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _sync(dev)
    setup_s = time.time() - ctx.t0 - check_s
    ctx.log(f"set-up {setup_s:.3f} s (+ {check_s:.3f} s of checks); "
            f"cycle {pace:.3f} s -> window of {cycles} cycles "
            f"({len(plan)} batches)")

    out = []
    w0 = time.perf_counter()
    for i, L in enumerate(plan):
        tw.unit(i)
        out.append(batch(i, L))
    _sync(dev)
    elapsed = time.perf_counter() - w0
    tw.finish()
    tokens = B * sum(plan)
    rate = tokens / elapsed
    peak = torch.cuda.max_memory_allocated() \
        if torch.device(dev).type == "cuda" else 0
    ctx.log(f"window {elapsed:.3f} s, {len(plan)} batches, {rate:.3f} "
            f"prompt tokens/s; peak {peak / 1e9:.3f} GB")
    summary = tw.summary(ctx.log) if ctx.trace else None
    readings = {"kind": "prefill", "tokens_per_s": rate}
    if summary is not None:
        traced = plan[summary.first:summary.last]
        readings.update(_trace_readings(summary, model, B, cfg, plan))
        readings["flops_per_token"] = sum(
            roofline.forward_flops_per_token(model, L) * L
            for L in traced) / sum(traced)

    # the sample: batches drawn from the seed, the longest length among
    # them, held to the reference
    got = [o.reshape(-1).cpu() for o in out]
    del served, out
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    pick = _sample(plan, int(own["check"]["sample_batches"]), ctx.seed)
    w = weights.make(specs, ctx.seed, dev)
    worst, missing = 0.0, 0
    for i in pick:
        p = traffic.prompts(ctx.seed, i, B, plan[i], V, dev)
        toks = got[i]
        if toks.numel() != B:
            missing += B - min(toks.numel(), B)
            continue
        gaps = ref_serve.served_gaps(w, model, p, toks.to(dev),
                                     int(own["check"].get("rows", 1)))
        worst = max(worst, float(gaps.max()))
    ctx.log(f"reference {time.perf_counter() - t:.3f} s over {len(pick)} "
            f"batches ({len(pick) * B} served tokens, lengths "
            f"{sorted(plan[i] for i in pick)})")
    lim = limits(ctx.cell)
    checks = [("token_gap", worst, lim["token_gap"]),
              ("missing", missing, lim["missing"]),
              ("restore_bad", restore_bad, lim["restore_bad"])]
    return Outcome(e2e={ctx.cell.settings["rate_metric"]: rate,
                        "setup_s": setup_s},
                   attempted=B * len(plan), failed=0, checks=checks,
                   readings=readings, summary=summary,
                   memory_peak_bytes=int(peak))


def _sample(plan, k: int, seed: int):
    """``k`` batch indices of the window drawn from the seed, one of them
    at the longest prompt length."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x5A3]))
    longest = [i for i, L in enumerate(plan) if L == max(plan)]
    first = int(rng.choice(longest))
    rest = [i for i in range(len(plan)) if i != first]
    k = min(k, len(plan))
    return [first] + sorted(int(i) for i in rng.choice(rest, k - 1,
                                                       replace=False))


def _trace_readings(s, model: dict, B: int, cfg, plan) -> dict:
    """The traced try's SSD kernel time beside the least time of its scans
    (each batch's layers at its prompt length)."""
    di = model["ssm_expand"] * model["d_model"]
    bound = 0.0
    for L in plan[s.first:s.last]:
        shape = (B, L, di // model["ssm_head_dim"], model["ssm_head_dim"],
                 model["ssm_n_groups"], model["ssm_state_dim"],
                 model["ssm_chunk"])
        bound += model["n_layers"] * roofline.ssd_bound_ms(
            shape, cfg.compute_dtype)
    expect = model["n_layers"] * (s.last - s.first)
    return {"busy_s": s.busy_s, "window_s": s.window_s,
            "kernel_ms": s.kernel_ms,
            "bound_ms": {"ssd_fwd": bound if s.calls["ssd_fwd"] == expect
                         else None},
            "tokens_per_s": B * sum(plan[s.first:s.last]) / s.window_s}
