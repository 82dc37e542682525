"""Journaled training on the PyTorch port: train a language model with the
Arcadia log as the training journal — checkpoints, per-step journal
records with the grads' integrity hashes, a simulated crash at 60% of
the run, and an exact resume (the port's counterpart of
examples/journaled_training.py).  The card by default; ``--device cpu``
runs the plain versions of the kernels.

The journal log is deliberately far smaller than the run's traffic (a
32 KiB ring absorbing many manifests and journal records): the
checkpoint+truncate lifecycle (DESIGN.md §13) keeps it alive — when free
space crosses the low-water mark, the manager GCs superseded checkpoints
and advances the durable trim watermark behind the newest one, so the
ring never fills.

The default preset is mamba2-130m at its published widths (24 layers,
the SSD scan and its backward on their kernels) for 40 steps of 8 x 1024
tokens; ``--preset reduced`` is its smoke-test scale for the CPU.

    PYTHONPATH=src python examples/torch_journaled_training.py
    PYTHONPATH=src python examples/torch_journaled_training.py \\
        --preset reduced --device cpu
"""

import argparse
import time

import numpy as np

from repro_torch.checkpoint import (CheckpointConfig, CheckpointManager,
                                    ObjectStore, ReplicatedStore)
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import Log, LogConfig, PMEMDevice
from repro_torch.core.replication import device_size
from repro_torch.data import DataConfig, SyntheticDataset
from repro_torch.device import resolve_device
from repro_torch.launch.train import check_trainable
from repro_torch.optim import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

PRESETS = {
    "mamba2-130m": dict(batch=8, seq=1024, steps=40),
    "reduced": dict(batch=4, seq=64, steps=30),
}
LOG_CAP = 1 << 15              # a few manifests: needs checkpoint+trim


def build(cfg, preset, steps, stores, log, device):
    mgr = CheckpointManager(ReplicatedStore(stores, write_quorum=2), log,
                            CheckpointConfig(force_freq=4, keep_last=1))

    # lifecycle wiring: below 50% free, GC reclaims the ring behind the
    # newest durable checkpoint instead of raising LogFullError mid-run;
    # the force first, since gc trims only behind durable manifests
    def reclaim(lg):
        if lg.next_lsn > 1:
            lg.force(lg.next_lsn - 1, freq=1)
        mgr.gc()

    log.cfg.free_space_low_frac = 0.5
    log.on_free_space_low = reclaim
    data = SyntheticDataset(cfg, DataConfig(batch=preset["batch"],
                                            seq_len=preset["seq"]))
    opt = OptConfig(name="adamw", lr=3e-3, warmup_steps=5,
                    decay_steps=max(2 * steps, 100))
    return Trainer(cfg, opt, data, mgr,
                   TrainerConfig(total_steps=steps, ckpt_every=5,
                                 journal_freq=4, async_ckpt=False),
                   device=device)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="mamba2-130m", choices=list(PRESETS))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=None)
    args = ap.parse_args()

    preset = PRESETS[args.preset]
    steps = args.steps or preset["steps"]
    cfg = reduced_config("mamba2-130m") if args.preset == "reduced" else \
        get_config("mamba2-130m")
    check_trainable(cfg, args.device, preset["seq"])
    device = resolve_device(args.device)
    print(f"[e2e] model: {cfg.name} {cfg.param_count() / 1e6:.1f}M params "
          f"({args.preset} preset) on {device}, {steps} steps of "
          f"{preset['batch']} x {preset['seq']} tokens")

    stores = [ObjectStore(f"s{i}") for i in range(3)]
    log = Log.create(PMEMDevice(device_size(LOG_CAP)),
                     LogConfig(capacity=LOG_CAP), device=device)

    # ---- phase 1: train until a "crash" at 60% of the run -------------
    crash_at = int(steps * 0.6)
    tr = build(cfg, preset, steps, stores, log, device)
    tr.init_or_restore()
    t0 = time.perf_counter()
    tr.run(n_steps=crash_at)
    print(f"[e2e] ...simulated crash at step {crash_at} "
          f"(loss {tr.report.losses[-1]:.3f}); trainer state discarded")

    # ---- phase 2: a fresh trainer restores and finishes ----------------
    tr2 = build(cfg, preset, steps, stores, log, device)
    restored = tr2.init_or_restore()
    seated = tr2.data.step
    print(f"[e2e] restored checkpoint step={restored}, journal re-seated "
          f"data at step {seated}")
    rep = tr2.run()
    dt = time.perf_counter() - t0
    print(f"[e2e] finished: {crash_at} + {rep.steps_run} steps in {dt:.0f}s; "
          f"loss {tr.report.losses[0]:.3f} -> {rep.losses[-1]:.3f}; "
          f"ckpts={tr.report.ckpts_saved + rep.ckpts_saved}")
    assert seated == crash_at, \
        "the journal did not re-seat the data at the crash"
    # the steps between the checkpoint and the crash run again from the
    # restored state: the same losses
    assert restored < crash_at
    np.testing.assert_allclose(rep.losses[:crash_at - restored],
                               tr.report.losses[restored:crash_at], rtol=1e-5)
    print(f"[e2e] exact resume: steps {restored}..{crash_at - 1} replayed "
          f"with the same losses")
    first = np.mean(tr.report.losses[:10])
    last = np.mean(rep.losses[-10:])
    assert last < first, "training did not converge"
    print("[e2e] convergence check passed")

    st = log.stats()
    appended = st["trimmed_bytes"] + st["used"]
    print(f"[e2e] log lifecycle: {appended / 1024:.0f} KiB journaled "
          f"through a {LOG_CAP // 1024} KiB ring "
          f"({appended / LOG_CAP:.1f}x capacity); "
          f"{st['trimmed_records']} records trimmed across "
          f"{st['space_low_triggers']} space-low reclaims, "
          f"watermark at lsn {st['trim_lsn']}, "
          f"full-ring stalls={st['full_reclaims']}")
    assert appended > LOG_CAP, "the ring was never reused"
    assert st["full_reclaims"] == 0, "ring filled despite the lifecycle"
    print("[e2e] lifecycle check passed: ring never filled")


if __name__ == "__main__":
    main()
