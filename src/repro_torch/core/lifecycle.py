"""Crash-consistent log lifecycle: checkpoint + truncate + bounded
recovery (DESIGN.md §13).

The ring only fills; a service handling real traffic runs for months.
This module wires the three pieces that make long-running operation
safe into one ordering the crash story can defend:

  1. snapshot the application state through the checkpoint manager
     (manifest committed as a log record — quorum-durable),
  2. advance the durable trim watermark (ONE 8-byte-atomic store +
     flush, `Log.trim`) over everything the snapshot covers,
  3. reclaim the ring space in O(1) bookkeeping.

A crash at any point recovers either the pre-trim view (snapshot there
but watermark not yet flushed — records replay from the log) or the
post-trim view (watermark flushed — records come from the snapshot):
acked records are never lost, trimmed records never resurrect.

`LogLifecycle.attach` registers the orchestrator as the log's
free-space-low callback, so backpressure triggers checkpoint+trim
instead of `LogFullError` mid-wave — graceful degradation under the
ingest engine's admission modes.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from .log import Log, TrimError

__all__ = ["LifecycleConfig", "TrimReport", "LogLifecycle", "TrimError"]


@dataclass
class LifecycleConfig:
    # free-ring fraction at or below which backpressure fires a
    # checkpoint+trim (installed into LogConfig.free_space_low_frac by
    # attach() unless the log already configures one)
    free_space_low_frac: float = 0.25
    # manifests commit synchronously by default: the watermark must not
    # advance past records an un-committed snapshot claims to cover
    sync_saves: bool = True
    # skip the checkpoint entirely when fewer than this many records
    # would be reclaimed (a hot loop of crossings must not thrash saves)
    min_trim_records: int = 1
    # bound kept TrimReports (observability, not a ledger)
    history_cap: int = 1024


@dataclass
class TrimReport:
    """One checkpoint+trim cycle's accounting."""
    step: int                     # checkpoint step committed
    manifest_lsn: int             # its manifest record LSN
    trimmed_upto: int             # new durable trim watermark (0 = no-op)
    head_lsn: int                 # log head after the cycle
    reclaimed_bytes: int
    reclaimed_records: int
    trigger: str                  # "manual" | "space_low" | "log_full"
    wall_s: float
    vns: float = 0.0


class LogLifecycle:
    """Checkpoint+trim orchestrator over one log.

    ``state_fn`` returns the application state pytree to snapshot —
    called under the lifecycle lock, so it must produce a consistent
    view on its own (e.g. the app's table snapshot, a model's params).
    The snapshot commits BEFORE the watermark advances; `Log.trim`
    enforces the other half of the contract (never past the durable
    watermark).
    """

    def __init__(self, manager, state_fn: Callable[[], Any],
                 cfg: Optional[LifecycleConfig] = None,
                 extra_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 start_step: int = 0):
        self.manager = manager
        self.log: Log = manager.log
        self.state_fn = state_fn
        self.extra_fn = extra_fn
        self.cfg = cfg or LifecycleConfig()
        # RLock: a manual cycle's own manifest append can cross the
        # free-space threshold and re-enter via the log callback; the
        # log's fired-latch bounds that recursion at depth one
        self._lock = threading.RLock()
        self._step = start_step
        self.reports: List[TrimReport] = []
        self.cycles = 0
        self.noop_cycles = 0

    # -- wiring --------------------------------------------------------- #
    def attach(self) -> "LogLifecycle":
        """Register as the log's free-space-low callback (and install
        the config threshold unless the log already has one)."""
        if self.log.cfg.free_space_low_frac is None:
            self.log.cfg.free_space_low_frac = self.cfg.free_space_low_frac
        self.log.on_free_space_low = self._on_space_low
        return self

    def detach(self) -> None:
        # == not `is`: bound-method objects are re-created per access
        if self.log.on_free_space_low == self._on_space_low:
            self.log.on_free_space_low = None

    def _on_space_low(self, log: Log) -> None:
        self.checkpoint_and_trim(trigger="space_low")

    # -- the cycle ------------------------------------------------------ #
    def checkpoint_and_trim(self, trigger: str = "manual") -> TrimReport:
        """Snapshot app state, commit the checkpoint, advance the trim
        watermark over everything it covers (via the manager's GC
        boundary: up to the oldest kept manifest)."""
        with self._lock:
            t0 = time.monotonic()
            st0 = self.log.stats()
            self._step += 1
            extra = self.extra_fn() if self.extra_fn is not None else None
            lsn = self.manager.save(self._step, self.state_fn(),
                                    extra=extra, sync=self.cfg.sync_saves)
            reclaimable = lsn - st0["head_lsn"]
            if reclaimable < self.cfg.min_trim_records:
                self.noop_cycles += 1
            self.manager.gc()
            st1 = self.log.stats()
            rep = TrimReport(
                step=self._step, manifest_lsn=lsn,
                trimmed_upto=st1["trim_lsn"], head_lsn=st1["head_lsn"],
                reclaimed_bytes=st1["trimmed_bytes"] - st0["trimmed_bytes"],
                reclaimed_records=(st1["trimmed_records"]
                                   - st0["trimmed_records"]),
                trigger=trigger, wall_s=time.monotonic() - t0)
            self.cycles += 1
            if len(self.reports) < self.cfg.history_cap:
                self.reports.append(rep)
            return rep

    # -- observability -------------------------------------------------- #
    def stats(self) -> dict:
        with self._lock:
            total_reclaimed = sum(r.reclaimed_bytes for r in self.reports)
            return dict(cycles=self.cycles, noop_cycles=self.noop_cycles,
                        step=self._step,
                        reclaimed_bytes=total_reclaimed,
                        trim_lsn=self.log.trim_lsn,
                        space_low_triggers=self.log.space_low_triggers,
                        full_reclaims=self.log.full_reclaims)
