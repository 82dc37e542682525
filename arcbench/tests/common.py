"""Tiny versions of the cells for the CPU tests."""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from arcbench.harness import main as hm  # noqa: E402
from arcbench.harness import spec  # noqa: E402

SSM = dict(n_layers=2, d_model=64, vocab_size=512, ssm_head_dim=16,
           ssm_state_dim=16, ssm_chunk=32)
DENSE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab_size=512)
TINY = {
    "mamba2-130m.train": (SSM, dict(batch=2, seq_len=64)),
    "starcoder2-3b.train": (DENSE, dict(batch=2, seq_len=64)),
    "mamba2-130m.train-ckpt": (SSM, dict(batch=2, seq_len=64, ckpt_every=4)),
    "mamba2-130m.prefill": (SSM, dict(batch=2, lengths=[32, 64, 64, 128])),
}
SEED = 2 ** 31 + 977


def tiny_cell(name: str) -> spec.Cell:
    cell = spec.cell(name)
    cell.traffic.update(TINY[name][1])
    if cell.driver == "prefill":
        cell.settings["check"]["sample_batches"] = 3
    return cell


def run_tiny(name: str, plant=None, seed: int = SEED, seconds: float = 1.0):
    """One run of the tiny cell on the CPU, the chip's check skipped;
    ``plant`` wraps the program's timed call to break it."""
    cell = tiny_cell(name)
    ctx = hm.Context(cell=cell, seed=seed, seconds=seconds, trace=False,
                     t0=time.time(), device="cpu", overrides=TINY[name][0],
                     plant=plant, log=lambda _m: None)
    return spec.driver_module(cell.driver).run(ctx)
