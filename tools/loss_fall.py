#!/usr/bin/env python3
"""Does mamba2-130m's loss fall over 12 steps on the card?

    python3 tools/loss_fall.py [--rates 3e-3,1e-3,3e-4] [--seeds 0,1,2]

Trains mamba2-130m at its published widths (8 x 4096 tokens a step from
the synthetic pipeline, AdamW with chip_smoke.py's schedule, the state
functional as ``Trainer`` runs it, params from ``init_params``) for 12
steps from each seed and rate.  Prints each run's losses and whether the
mean of the last four falls below the mean of the first four,
chip_smoke.py's check of the training path (its readings are in the
comment on ``TRAIN_LR`` there).  Needs a card (about a minute for the
defaults).
"""

from __future__ import annotations

import argparse
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticDataset  # noqa: E402
from repro_torch.kernels import nvcc  # noqa: E402
from repro_torch.kernels.checksum import checksum  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import OptConfig, init_opt_state  # noqa: E402
from repro_torch.train import step as S  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rates", default="3e-3,1e-3,3e-4")
    ap.add_argument("--seeds", default="0,1,2")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("loss_fall: no CUDA device", file=sys.stderr)
        return 2
    sources = [checksum.SOURCE, ssd_scan.SOURCE, ssd_scan.TC_SOURCE,
               ssd_scan.BWD_SOURCE, ssd_scan.BWD_TC_SOURCE]
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(nvcc.build, sources))
    cfg = get_config("mamba2-130m")
    for lr in (float(r) for r in args.rates.split(",")):
        for seed in (int(s) for s in args.seeds.split(",")):
            opt = OptConfig(name="adamw", lr=lr, warmup_steps=2,
                            decay_steps=1000, clip_norm=1.0)
            params = M.init_params(cfg, torch.Generator(
                device="cuda").manual_seed(seed), "cuda")
            state = {"params": params, "opt": init_opt_state(params, opt),
                     "step": torch.zeros((), dtype=torch.int32,
                                         device="cuda")}
            data = SyntheticDataset(cfg, DataConfig(batch=8,
                                                    seq_len=4096))
            losses = []
            for s in range(12):
                state, met = S.train_step(state, data.tensors_at(
                    s, "cuda"), cfg, opt, journal=True)
                losses.append(float(met["loss"]))
            first, last = np.mean(losses[:4]), np.mean(losses[-4:])
            print(f"lr {lr:g} seed {seed}: "
                  f"{[round(x, 3) for x in losses]}; first four "
                  f"{first:.4f}, last four {last:.4f}, falls "
                  f"{bool(last < first)}", flush=True)
            del state, params
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
