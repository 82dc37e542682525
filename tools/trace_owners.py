#!/usr/bin/env python3
"""One traced run of a benchmark cell, read by the port's own spans.

    python3 tools/trace_owners.py --workload mamba2-130m.train --seed 7 \\
        --seconds 51

Runs ``arcbench/run.py``'s ``--trace 1`` run of the cell in this process
and, beside the harness's readings, reads each traced try with
``arcbench/harness/spans.py``: the top owners of device time (the
innermost ``repro_torch.*`` span around each launch, a backward operation
through its forward operator), the idle gaps named by the program's spans
(and a checkpoint span open on a save thread), and the checks that the
attribution closes: the owners' sum against the traced device time,
``step.hash`` against the hash kernels, each SSD scan kernel's owner, the
share under the step's spans.  It also reads the port's counters around
the measured window (``TrainerReport.data_s``, ``Log.stats()``'s
``forces`` and ``force_s``, ``CheckpointManager.stats()``, the causal
conv's launch counters) and the conv's counters around every
``launch/serve.generate`` call; and the device time of each of the port's
own kernels by name.

The tries record every thread's ranges (``profile_all_threads``), so the
save workers' ``ckpt.*`` spans are in the trace.  The report is the line
``[owners] {...}`` on standard error and
``artifacts/trace_owners/<cell>-<seed>.json``; the harness's result line
is printed as it prints it.  Needs a CUDA card.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

STEP_PREFIXES = ("trainer.", "step.", "optim.", "model.")
# the port's hand-written kernels, reported by name whatever their rank
PORT_KERNELS = re.compile(
    r"\w*(causal_conv_|ssd_|bwd_(tc|cc)_|flash_|checksum_)\w*(<[^()]*>)?")


def conv_counters() -> dict:
    from repro_torch.kernels.causal_conv import causal_conv as cc
    return {"conv_launches": cc.LAUNCHES,
            "conv_backward_launches": cc.BACKWARD_LAUNCHES}


def counters(tr) -> dict:
    log, mgr = tr.mgr.log.stats(), tr.mgr.stats()
    return {"data_s": tr.report.data_s, "forces": log["forces"],
            "force_s": log["force_s"], **mgr, **conv_counters()}


def watch_generate(calls: list) -> None:
    """Record the conv's counters around every ``generate`` call."""
    from repro_torch.launch import serve
    generate = serve.generate

    @functools.wraps(generate)
    def watched(*args, **kwargs):
        before = conv_counters()
        out = generate(*args, **kwargs)
        after = conv_counters()
        calls.append(tuple(after[k] - before[k] for k in after))
        return out
    serve.generate = watched


def watch_runs(calls: list) -> None:
    """Record the counters around every ``Trainer.run`` call."""
    from repro_torch.train.trainer import Trainer
    run = Trainer.run

    @functools.wraps(run)
    def watched(self, n_steps=None):
        before = counters(self)
        out = run(self, n_steps)
        after = counters(self)
        calls.append({"steps": n_steps,
                      **{k: after[k] - before[k] for k in after}})
        return out
    Trainer.run = watched


def window_readings(calls: list) -> dict:
    """The counters' readings over the measured window (the longest
    ``Trainer.run`` call)."""
    if not calls:
        return {}
    w = max(calls, key=lambda c: c["steps"] or 0)
    out = {"window_steps": w["steps"],
           "data_ms_per_step": 1e3 * w["data_s"] / w["steps"],
           "conv_per_step": [w[k] / w["steps"] for k in (
               "conv_launches", "conv_backward_launches")]}
    if w["forces"]:
        out["journal_force_ms"] = 1e3 * w["force_s"] / w["forces"]
        out["forces"] = w["forces"]
    if w["snapshot_s"]:
        out["snapshot_gb_per_s"] = w["snapshot_bytes"] / w["snapshot_s"] / 1e9
        out["snapshot_bytes"] = w["snapshot_bytes"]
    return out


def owners_report(t, s, spans, trace) -> dict:
    fams = {f: p for f, (p, _) in trace.FAMILIES.items()}
    got = spans.read(t.prof, fams)
    by = got.device_s_by_span
    total = got.total_s
    units = s.last - s.first

    def share(name):
        return 100.0 * by.get(name, 0.0) / s.busy_s if s.busy_s else None

    port: dict = {}
    for (_, op), v in got.by_span_op.items():
        m = PORT_KERNELS.search(op)
        if m:
            port[m.group(0)] = port.get(m.group(0), 0.0) + v
    return {
        "units": [s.first, s.last],
        "window_s": s.window_s, "busy_s": s.busy_s,
        "ms_per_unit": 1e3 * s.window_s / units if units else None,
        "device_total_s": total,
        "owners_sum_s": sum(by.values()),
        "top_owners": spans.top(by, 16),
        "top_owner_ops": [[f"{k[0]} | {k[1][:90]}", v] for k, v in
                          spans.top(got.by_span_op, 24)],
        "port_kernels_s": spans.top(port, 64),
        "optim_share_pct": share("optim.apply_updates"),
        "logits_share_pct": share("model.logits"),
        "step_hash_s": by.get("step.hash"),
        "hash_kernel_s": s.kernel_ms["hash"] / 1e3,
        "family_owners": got.family_owners,
        "under_step_spans_pct": 100.0 * sum(
            v for k, v in by.items() if k.startswith(STEP_PREFIXES))
        / total if total else None,
        "at_step_backward_pct": 100.0 * by.get("step.backward", 0.0)
        / total if total else None,
        "unowned_pct": 100.0 * sum(
            v for k, v in by.items() if k.startswith("(")) / total
        if total else None,
        "idle_gaps": got.idle_gaps,
        "idle_by_span": spans.top(got.idle_s_by_span, 12),
        "harness_idle_gaps": s.idle_gaps,
        "harness_device_ops": s.device_ops,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()

    import torch
    from arcbench.harness import main as hm
    from arcbench.harness import spans, trace

    from torch._C._profiler import _ExperimentalConfig
    torch.profiler.profile = functools.partial(
        torch.profiler.profile, experimental_config=_ExperimentalConfig(
            profile_all_threads=True))
    reports, calls = [], []
    read = trace.read

    def read_and_own(t):
        s = read(t)
        t0 = time.perf_counter()
        reports.append(owners_report(t, s, spans, trace))
        reports[-1]["read_s"] = time.perf_counter() - t0
        return s
    trace.read = read_and_own
    watch_runs(calls)
    generate_calls: list = []
    watch_generate(generate_calls)

    rc = hm.main(["--workload", args.workload, "--seed", str(args.seed),
                  "--seconds", str(args.seconds), "--trace", "1"], T0)
    out = {"workload": args.workload, "seed": args.seed, "rc": rc,
           "counters": window_readings(calls),
           "conv_per_generate": sorted(set(generate_calls)),
           "tries": reports}
    text = json.dumps(out)
    print(f"[owners] {text}", file=sys.stderr, flush=True)
    dest = ROOT / "artifacts" / "trace_owners"
    dest.mkdir(parents=True, exist_ok=True)
    (dest / f"{args.workload}-{args.seed}.json").write_text(text)
    return rc


if __name__ == "__main__":
    sys.exit(main())
