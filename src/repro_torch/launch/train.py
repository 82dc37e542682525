"""Training launcher (the JAX package's ``launch/train.py``), on the card
unless ``--device cpu`` is given.

Selects an architecture config (full or reduced), builds the replicated
Arcadia log (manifests and journal) and the checkpoint stores, and runs
the fault-tolerant ``Trainer`` with every step journaled (the grads'
integrity hashes beside the loss).  Parameters are initialised from
``--seed``; batches come from the synthetic pipeline.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --steps 12 --batch 8 --seq 4096 --ckpt-every 4 --journal-freq 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
      --reduced --device cpu --steps 20 --batch 4 --seq 64

On the card every config trains whose attention head dims the flash
kernels take (all ten): the SSM mixer's scan and flash attention each
have a backward kernel there, and ``check_trainable`` refuses anything
else before anything is allocated.  Whether a config fits the card is
another matter (gemma2-9b, starcoder2-3b, hubert-xlarge and deepseek-v3
cut to one dense layer and its MTP block train in ``chip_smoke.py``).
On the CPU every config trains, on the plain versions.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from ..checkpoint import (CheckpointConfig, CheckpointManager, FileStore,
                          ObjectStore, ReplicatedStore)
from ..configs import ARCH_NAMES, get_config, reduced_config
from ..core.replication import build_replica_set
from ..data import DataConfig, SyntheticDataset
from ..device import resolve_device
from ..kernels.flash_attention.flash_attention import MAX_HEAD_DIM
from ..models.config import ModelConfig
from ..optim import OptConfig
from ..train.trainer import Trainer, TrainerConfig


def check_trainable(cfg: ModelConfig, device, seq_len: Optional[int] = None
                    ) -> None:
    """Raise unless the port can train ``cfg`` on ``device``: on the card
    attention head dims the flash kernels take (q/k head dim D <= 256 and
    v head dim Dv <= D, both multiples of 4); with SSM layers, ``seq_len``
    at most ``ssm_chunk`` or a multiple of it."""
    kinds = cfg.block_pattern()
    attn = cfg.first_dense_layers > 0 or cfg.mtp_depth > 0 or \
        any(k.mixer == "attn" for k in kinds)
    if torch.device(device).type == "cuda" and attn:
        D = cfg.qk_nope_dim + cfg.qk_rope_dim if cfg.use_mla else \
            cfg.resolved_head_dim
        Dv = cfg.v_head_dim if cfg.use_mla else D
        if not (D <= MAX_HEAD_DIM and Dv <= D and D % 4 == 0 and
                Dv % 4 == 0):
            raise ValueError(
                f"{cfg.name}: attention head dims ({D}, {Dv}) are not taken "
                f"by the flash kernels (D <= {MAX_HEAD_DIM}, Dv <= D, both "
                f"multiples of 4), which train attention on the card; pass "
                f"--device cpu")
    q = cfg.ssm_chunk
    if seq_len is not None and any(k.mixer == "ssm" for k in kinds) and \
            seq_len > q and seq_len % q:
        raise ValueError(f"sequence length {seq_len} must be <= {q} or a "
                         f"multiple of it (ssm_chunk)")


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-runnable)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--journal-freq", type=int, default=4,
                    help="F for the frequency-based force policy")
    ap.add_argument("--log-backups", type=int, default=1)
    ap.add_argument("--store-replicas", type=int, default=2)
    ap.add_argument("--store-dir", default=None,
                    help="directory-backed stores instead of in-memory")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else \
        get_config(args.arch)
    check_trainable(cfg, args.device, args.seq)
    device = resolve_device(args.device)
    print(f"[train] arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"(active {cfg.active_param_count()/1e6:.1f}M) on {device}")

    # replicated Arcadia log for manifests + journal
    rs = build_replica_set(
        mode="local+remote" if args.log_backups else "local",
        capacity=1 << 20, n_backups=args.log_backups,
        write_quorum=min(2, args.log_backups + 1), device=device)
    if args.store_dir:
        stores = [FileStore(f"{args.store_dir}/replica{i}", f"fs{i}")
                  for i in range(args.store_replicas)]
    else:
        stores = [ObjectStore(f"s{i}") for i in range(args.store_replicas)]
    rstore = ReplicatedStore(stores,
                             write_quorum=(args.store_replicas // 2) + 1)
    mgr = CheckpointManager(rstore, rs.log,
                            CheckpointConfig(force_freq=args.journal_freq))
    try:
        data = SyntheticDataset(cfg, DataConfig(batch=args.batch,
                                                seq_len=args.seq))
        opt = OptConfig(name=args.optimizer, lr=args.lr, warmup_steps=5,
                        decay_steps=max(args.steps * 2, 100))
        tr = Trainer(cfg, opt, data, mgr,
                     TrainerConfig(total_steps=args.steps,
                                   ckpt_every=args.ckpt_every,
                                   journal_freq=args.journal_freq,
                                   seed=args.seed),
                     device=device)
        start = tr.init_or_restore()
        if start:
            print(f"[train] resumed from step {start} "
                  f"(journal re-seated data at {tr.data.step})")
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        rep = tr.run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
    finally:
        mgr.close()
        rs.shutdown()
    toks = rep.steps_run * args.batch * args.seq
    print(f"[train] {rep.steps_run} steps in {dt:.1f}s "
          f"({rep.steps_run / max(dt, 1e-9):.2f} steps/s, "
          f"{toks / max(dt, 1e-9):.0f} tokens/s)")
    print(f"[train] loss {rep.losses[0]:.3f} -> {rep.losses[-1]:.3f}; "
          f"ckpts saved={rep.ckpts_saved} skipped={rep.ckpts_skipped}")
    if device.type == "cuda":
        print(f"[train] peak device memory "
              f"{torch.cuda.max_memory_allocated(device) / 1e9:.3f} GB")
    print(f"[train] log stats: {rs.log.stats()}")


if __name__ == "__main__":
    main()
