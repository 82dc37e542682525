"""Experiment registry over the dry run (the JAX package's
``launch/perf.py``): named variants of three cells, each a set of
``run_cell`` keyword arguments; results go to artifacts/perf/.

  PYTHONPATH=src python -m repro_torch.launch.perf --exp qwen2_nofsdp

The numbers are the dry run's (``launch/dryrun.py`` says what each is):
FLOPs and bytes from a fake run at one data-parallel shard, collective
bytes from the closed form over the placements, on no device.
"""

from __future__ import annotations

import argparse
from typing import Optional

from .dryrun import run_cell

OUT = "artifacts/perf"

# experiment registry: name -> run_cell kwargs
EXPERIMENTS = {
    # ---- cell A: qwen2-7b × train_4k (representative dense) ----------
    "qwen2_base": dict(arch="qwen2-7b", shape_name="train_4k",
                       multi_pod=False, variant="base"),
    # A1: drop FSDP => pure TP(model) × DP(data); params replicated over
    # data
    "qwen2_nofsdp": dict(arch="qwen2-7b", shape_name="train_4k",
                         multi_pod=False, fsdp_axes=(),
                         variant="nofsdp"),
    # A2: A1 + attention fully data-parallel (no head_dim sharding); the
    # optimizer state of the now-replicated attention weights is ZeRO-1
    # sharded over data
    "qwen2_dp_attn": dict(
        arch="qwen2-7b", shape_name="train_4k", multi_pod=False,
        fsdp_axes=(), rule_overrides={"head": ()},
        variant="dp_attn"),
    # A3: A1 + the residual stream pinned to the batch axes at the embed
    # and block boundaries (set_activation_spec)
    "qwen2_nofsdp_act": dict(
        arch="qwen2-7b", shape_name="train_4k", multi_pod=False,
        fsdp_axes=(), act_constraint=True, variant="nofsdp_act"),

    # ---- cell B: deepseek-v3-671b × train_4k --------------------------
    "deepseek_base": dict(arch="deepseek-v3-671b", shape_name="train_4k",
                          multi_pod=False, variant="base"),
    # B1: full EP — experts sharded over model×data (1 expert/device),
    # no contracting-dim sharding of expert weights
    "deepseek_ep256": dict(
        arch="deepseek-v3-671b", shape_name="train_4k", multi_pod=False,
        rule_overrides={"expert": (("model", "data"),)},
        fsdp_axes=(), variant="ep256"),
    # B2: all-to-all EP dispatch (set_moe_ep): routing per rank, dispatch
    # and combine as two all-to-alls over the 256-rank grid
    "deepseek_ep_a2a": dict(
        arch="deepseek-v3-671b", shape_name="train_4k", multi_pod=False,
        fsdp_axes=(), moe_ep=True, variant="ep_a2a"),
    # B3: B2 + FSDP kept for attention/dense weights
    "deepseek_ep_a2a_fsdp": dict(
        arch="deepseek-v3-671b", shape_name="train_4k", multi_pod=False,
        moe_ep=True, variant="ep_a2a_fsdp"),

    # ---- cell C: journaled step on the multi-pod mesh ----------------
    "journal_off": dict(arch="qwen2-7b", shape_name="train_4k",
                        multi_pod=True, fsdp_axes=(),
                        variant="journal_off"),
    "journal_on": dict(arch="qwen2-7b", shape_name="train_4k",
                       multi_pod=True, fsdp_axes=(), journal=True,
                       variant="journal_on"),
}


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", required=True,
                    choices=sorted(EXPERIMENTS) + ["all"])
    args = ap.parse_args(argv)
    names = sorted(EXPERIMENTS) if args.exp == "all" else [args.exp]
    failures = 0
    for name in names:
        r = run_cell(out_dir=OUT, **EXPERIMENTS[name])
        if r["status"] != "ok":
            failures += 1
            print(f"[perf] {name}: {r['status']} {r.get('error', '')}")
            continue
        cc = r["collective_bytes_per_device"]
        coll = sum(v for k, v in cc.items() if k != "count")
        print(f"[perf] {name}: flops/dev={r['flops_per_device']:.3e} "
              f"coll/dev={coll:.3e}B "
              + " ".join(f"{k}={v:.3e}" for k, v in cc.items()
                         if k != "count" and v))
    if failures:
        raise SystemExit(f"{failures} experiment(s) failed")


if __name__ == "__main__":
    main()
