"""Readings of the control and of the planted faults, for the limits of a
cell's correctness numbers.

The control is the plain reference put in the program's place and
computed one precision below the configuration's bfloat16: every matrix
product's operands rounded to float8 e4m3 with a per-tensor scale.  A
served model's control serves, after each prompt of the batches a run
checks, the token that this forward puts first, and is read by the same
``served_gaps`` as the program's served tokens.  A train cell's other
readings are taken the same way, with the reference in the program's
place: ``control_stored``, the control with every parameter also stored
one step below its dtype, and ``half_batch``, half of the batch left out
(the mean over the rest); a state left unchanged reads 1 by the measure
and needs no run.

    python3 -m arcbench.tests.control --workload mamba2-130m.train \\
        --seeds 11,12,13 [--readings control,half_batch | program]

prints one JSON line a seed: the numbers each reading gives against the
float32 reference; ``program`` reads the program's own sound runs, one
seed after another in this process.  ``test_arcbench_control.py`` runs the same at a size
the CPU holds.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from arcbench.harness import spec, traffic, weights  # noqa: E402
from arcbench.reference import model as ref_model  # noqa: E402
from arcbench.reference import serve as ref_serve  # noqa: E402
from arcbench.reference import train as ref_train  # noqa: E402


TRAIN_READINGS = {
    "control": dict(ops=ref_model.Ops(fp8=True)),
    "control_stored": dict(ops=ref_model.Ops(fp8=True, store_low=True)),
    "half_batch": dict(ops=ref_model.Ops(), half=True),
}


def train_readings(cell: spec.Cell, seed: int, device, overrides=None,
                   mix=None, which=("control",)) -> dict:
    from arcbench.harness import deploy
    conf = cell.config
    model = {**conf["model"], **(overrides or {})}
    mix = {**cell.traffic, **(mix or {})}
    cfg = deploy.model_config(conf, overrides)
    specs = weights.port_specs(cfg)
    data = traffic.SyntheticDataset(cfg, traffic.DataConfig(
        seed=seed, batch=mix["batch"], seq_len=mix["seq_len"]))
    steps = int(cell.settings["check"]["follow_steps"])
    rows = int(cell.settings["check"].get("rows", 1))
    batches = [data.tensors_at(s, device) for s in range(steps)]
    opt = conf["deployment"]["optimizer"]
    make = lambda: weights.make(specs, seed, device)  # noqa: E731
    out = {"seed": seed}
    t = time.perf_counter()
    want = ref_train.follow(make, model, batches, opt, ref_model.Ops(), rows,
                            keep_first=True)
    out["reference_s"] = time.perf_counter() - t
    first = want.pop("first_tensors")
    for name in which:
        got = ref_train.follow(make, model, batches, opt, rows=rows,
                               judge=first, **TRAIN_READINGS[name])
        g = ref_train.gaps(got, want)
        out[name] = {k: g[k] for k in ("loss_gap", "grad_gap", "grad_err",
                                       "change_gap")}
        out[name]["leaves"] = [g["grad_gap_leaf"], g["grad_err_leaf"],
                               g["change_gap_leaf"]]
    del first
    out["null_leaves"] = ref_train.gaps(want, want)["null_leaves"]
    return out


def prefill_readings(cell: spec.Cell, seed: int, device, overrides=None,
                     mix=None, cycles: int = 24, which=("control",)) -> dict:
    """The control served in the program's place over the batches a run
    of ``cycles`` cycles would check, read by ``served_gaps``."""
    from arcbench.drivers.prefill import _sample
    from arcbench.harness import deploy
    conf = cell.config
    model = {**conf["model"], **(overrides or {})}
    mix = {**cell.traffic, **(mix or {})}
    cfg = deploy.model_config(conf, overrides)
    specs = weights.port_specs(cfg)
    rows = int(cell.settings["check"].get("rows", 1))
    plan = traffic.prompt_plan(mix["lengths"], cycles + 1,
                               seed)[len(mix["lengths"]):]
    pick = _sample(plan, int(cell.settings["check"]["sample_batches"]), seed)
    w = weights.make(specs, seed, device)
    gaps = []
    t = time.perf_counter()
    for i in pick:
        p = traffic.prompts(seed, i, mix["batch"], plan[i],
                            model["vocab_size"], device)
        toks = ref_serve.control_tokens(w, model, p,
                                        ref_model.Ops(fp8=True), rows)
        gaps += ref_serve.served_gaps(w, model, p, toks, rows).tolist()
    return {"seed": seed, "control": {"token_gap": max(gaps)},
            "flipped": sum(g > 0 for g in gaps), "served": len(gaps),
            "batches": len(pick), "seconds": time.perf_counter() - t}


def program_readings(cell: spec.Cell, seed: int, seconds: float = 1.0
                     ) -> dict:
    """The numbers a sound run of the program gives (the cell's driver on
    the card, with a short window): the lower readings of the limits."""
    from arcbench.harness import env
    from arcbench.harness import main as hm
    env.fixed_caches(spec.ROOT)
    logs = []
    ctx = hm.Context(cell=cell, seed=seed, seconds=seconds, trace=False,
                     t0=time.time(), log=logs.append)
    out = spec.driver_module(cell.driver).run(ctx)
    return {"seed": seed, "correct": out.correct,
            "program": {n: v for n, v, _ in out.checks},
            "log": [m for m in logs if m.startswith("reference")]}


def readings(cell: spec.Cell, seed: int, device, **kw) -> dict:
    fn = train_readings if cell.driver == "train" else prefill_readings
    return fn(cell, seed, device, **kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--readings", default="control",
                    help="comma-separated: control, control_stored, "
                         "half_batch (train cells); or program, the "
                         "program's own sound runs")
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    which = tuple(args.readings.split(","))
    for s in (int(v) for v in args.seeds.split(",")):
        if which == ("program",):
            r = program_readings(cell, s)
        else:
            r = readings(cell, s, "cuda", which=which)
        print(json.dumps({"workload": cell.name, **r}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
