"""One run of one cell: set-up, the measured window, the check, the
result line.

    python3 arcbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is the result's JSON; the last lines of
standard error are the numbers the check compared, each beside its
limit.  A run without enough cards, without the program, or with JAX or
the JAX package loaded prints no result and exits with a code other than
0.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from . import env, spec


def log(msg: str) -> None:
    print(f"[arcbench] {msg}", file=sys.stderr, flush=True)


@dataclass
class Context:
    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    t0: float                               # the process's start, time.time()
    device: str = "cuda"
    overrides: dict = field(default_factory=dict)   # tests: tiny models
    # tests: wraps the program's timed call (the train step, or the served
    # tokens of a batch's prompts) to plant a fault underneath
    plant: Optional[Callable[[Callable], Callable]] = None
    log: Callable[[str], None] = log


@dataclass
class Outcome:
    e2e: Dict[str, float]                   # the rate metric and setup_s
    attempted: int
    failed: int
    checks: List[Tuple[str, float, float]]  # (name, value, limit)
    readings: dict = field(default_factory=dict)
    summary: object = None                  # trace.TraceSummary
    memory_peak_bytes: int = 0

    @property
    def correct(self) -> bool:
        return all(isinstance(v, (int, float)) and math.isfinite(v)
                   and v <= lim for _, v, lim in self.checks) \
            and self.failed == 0


def limits(cell: spec.Cell) -> Dict[str, float]:
    return {k: float(v) for k, v in cell.settings["limits"].items()}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(ctx: Context, out: Outcome, kind: str) -> dict:
    """The result's JSON; ``kind`` is the card's name."""
    c = ctx.cell
    if ctx.trace:
        metrics = spec.per_layer_values(c, dict(out.readings))
    else:
        metrics = {m.name: {"value": out.e2e[m.name], "unit": m.unit}
                   for m in c.end_to_end}
    device = {"platform": "gpu", "kind": kind,
              "count": c.chips, "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if ctx.trace and out.summary is not None:
        s = out.summary
        device.update(busy_s=s.busy_s, window_s=s.window_s)
        line["breakdown"] = {"device_ops": s.device_ops,
                             "idle_gaps": s.idle_gaps}
    line["checks"] = {n: {"value": v, "limit": lim}
                      for n, v, lim in out.checks}
    return line


def main(argv, t0: float) -> int:
    args = parse(argv)
    env.fixed_caches(spec.ROOT)
    import torch
    try:
        cell = spec.cell(args.workload)
    except (KeyError, OSError) as e:
        log(f"no such cell: {e}")
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" available")
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        log(f"the program (repro_torch under src/) is missing: {e}")
        return 2
    log(f"{cell.name} seed {args.seed} seconds {args.seconds} trace "
        f"{args.trace} on {env.card_line()}; host memory free "
        f"{env.host_free_gb():.1f} GB; {time.time() - t0:.3f} s in")
    ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), t0=t0)
    out = spec.driver_module(cell.driver).run(ctx)
    bad = env.forbidden_modules()
    if bad:
        log(f"forbidden modules loaded in this process: {bad}")
        return 3
    line = result_line(ctx, out, torch.cuda.get_device_name(0))
    for n, v, lim in out.checks:
        log(f"check {n} {v!r} limit {lim!r}")
    print(json.dumps(line), flush=True)
    return 0
