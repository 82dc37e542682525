"""Fault-tolerant trainer: the Arcadia log as the training journal (the JAX
package's ``train/trainer.py``).

Every ``journal_every`` steps the trainer journals (step, loss) to the log
under the frequency-based force policy; every ``ckpt_every`` steps it
saves a checkpoint through the log-backed manager, asynchronously by
default so shard writes overlap the next steps.  Fault tolerance:

  * crash/restart  — restore the newest committed checkpoint, then replay
    the journal to re-seat the data pipeline at the exact batch; bounded
    loss: F×T journal records (§4.4).
  * straggler mitigation — an async save still in flight when the next
    checkpoint is due is skipped over (counted), so one slow writer never
    stalls the step loop.
  * elastic restore — checkpoints reassemble from chunks, so a run
    checkpointed with N writer groups restores onto M.

The step runs on ``device`` (the card unless the caller passes the CPU),
eagerly, always journaled: ``metrics["integrity"]`` holds one hash per
grad leaf (the JAX package's trainer runs its step without the journal).
``step_fn`` is the step the loop calls (``train_step`` with the config
bound), which a caller may wrap.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import partial
from typing import List, Optional

import torch

from ..checkpoint import CheckpointManager
from ..data import SyntheticDataset
from ..device import resolve_device
from ..models.config import ModelConfig
from ..optim import OptConfig
from ..trace import span
from .step import init_train_state, train_step


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 10
    journal_freq: int = 4        # F for journal force policy
    journal_every: int = 1       # journal a record every k steps
    seed: int = 0
    async_ckpt: bool = True


@dataclass
class TrainerReport:
    steps_run: int = 0
    losses: List[float] = field(default_factory=list)
    ckpts_saved: int = 0
    ckpts_skipped: int = 0       # straggler mitigation skips
    restarts: int = 0
    restored_step: Optional[int] = None
    data_s: float = 0.0          # host seconds in the batch fetch


class Trainer:
    def __init__(self, cfg: ModelConfig, opt_cfg: OptConfig,
                 dataset: SyntheticDataset, mgr: CheckpointManager,
                 tcfg: TrainerConfig, device="cuda"):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.data = dataset
        self.mgr = mgr
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.report = TrainerReport()
        self.step_fn = partial(train_step, cfg=cfg, opt_cfg=opt_cfg,
                               journal=True)
        self._pending_save = None
        self.state = None

    # ------------------------------------------------------------------ #
    def init_or_restore(self) -> int:
        """Fresh init, or restore newest checkpoint + journal replay."""
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        template = init_train_state(self.cfg, self.opt_cfg, gen,
                                    device=self.device)
        try:
            step, state, extra = self.mgr.restore(template)
        except FileNotFoundError:
            self.state = template
            return 0
        self.state = state
        self.report.restored_step = step
        self.report.restarts += 1
        # journal replay: find the newest durable data position
        data_pos = extra.get("data_state", {"seed": self.data.cfg.seed,
                                            "step": step})
        for _, rec in self.mgr.journal_records():
            if rec.get("step", -1) >= data_pos["step"]:
                data_pos = {"seed": self.data.cfg.seed,
                            "step": rec["step"] + 1}
        self.data.restore(data_pos)
        return step

    # ------------------------------------------------------------------ #
    def run(self, n_steps: Optional[int] = None) -> TrainerReport:
        start = int(self.state["step"])
        end = min(self.tcfg.total_steps,
                  start + (n_steps or self.tcfg.total_steps))
        for s in range(start, end):
            t = time.perf_counter()
            with span("trainer.data"):
                batch = self.data.tensors_at(s, self.device)
            self.report.data_s += time.perf_counter() - t
            self.data.step = s + 1
            self.state, metrics = self.step_fn(self.state, batch)
            with span("trainer.sync"):
                loss = float(metrics["loss"])
            self.report.losses.append(loss)
            self.report.steps_run += 1
            if s % self.tcfg.journal_every == 0:
                self.mgr.journal({"step": s, "loss": loss}, sync=False)
            if (s + 1) % self.tcfg.ckpt_every == 0:
                self._checkpoint(s + 1)
        # end-of-run: drain outstanding writes, force the journal
        self._drain()
        return self.report

    def _checkpoint(self, step: int) -> None:
        extra = {"data_state": self.data.state()}
        if self.tcfg.async_ckpt:
            if self._pending_save is not None and \
                    not self._pending_save.done():
                self.report.ckpts_skipped += 1   # straggler: skip over
                return
            self._pending_save = self.mgr.save_async(step, self.state,
                                                     extra)
        else:
            self.mgr.save(step, self.state, extra, sync=True)
        self.report.ckpts_saved += 1

    def _drain(self) -> None:
        self.mgr.wait()
        last = self.mgr.log.next_lsn - 1
        if last >= 1 and self.mgr.log.durable_lsn < last:
            self.mgr.log.force(last, freq=1)
