"""Force policies (§4.4): when does a log write become durable?

  * SyncPolicy   — force(freq=1) after every record: strongest freshness,
                   one persist+replicate round per record.
  * GroupCommitPolicy — classic group commit [Helland et al.]: a shared
                   window counter under a mutex; the thread that fills the
                   window forces the batch.  Implemented *with* the shared
                   counter on purpose — Fig. 8 shows exactly this counter
                   thrashing caches at high concurrency.
  * FreqPolicy   — the paper's frequency-based policy: a record whose
                   LSN ≡ 0 (mod F) makes its completing thread the force
                   leader for the batch; no shared state beyond the LSNs
                   that reserve() already hands out.  Bounded loss: F×T
                   completed records (worst case, Fig. 4).

All policies expose ``on_complete(log, rec_id)`` called after
``log.complete(rec_id)``, ``on_complete_batch(log, lsns)`` called after
``log.complete_batch(batch)`` (one policy decision — and at most one
force — for the whole batch), and ``drain(log)`` to force everything at
the end of a run.

Every policy takes ``wait`` (default True).  With ``wait=False`` a force
leader only *issues* its durability round into the log's pipelined force
engine (DESIGN.md §8) and hands back immediately — the non-blocking
leader handoff: the round retires in the background when its quorum
fills, up to ``LogConfig.pipeline_depth`` rounds overlap on the wire,
and any round failure surfaces on the next force or on ``drain``.
``drain`` always blocks: it forces the last reserved LSN, waits for the
pipeline to empty, and surfaces deferred round errors.
"""

from __future__ import annotations

import copy
import threading
from typing import List, Optional

from .log import Log


class ForcePolicy:
    name = "base"

    def __init__(self, wait: bool = True):
        self.wait = bool(wait)

    def nonblocking(self) -> "ForcePolicy":
        """This policy with ``wait=False`` (self if already non-blocking):
        leaders only *issue* rounds into the pipelined force engine.  The
        ingestion front end (DESIGN.md §10) forces through this so that
        slicing a big wave actually lands the slices in successive
        pipeline slots — producers get their blocking semantics from the
        durable ack, not from the force call."""
        if not self.wait:
            return self
        clone = copy.copy(self)
        clone.wait = False
        return clone

    def on_complete(self, log: Log, rec_id: int) -> None:
        raise NotImplementedError

    def on_complete_batch(self, log: Log, lsns: List[int]) -> None:
        """Batch hook: default mirrors the scalar decisions one by one;
        policies override to collapse them into a single force."""
        for lsn in lsns:
            self.on_complete(log, lsn)

    def drain(self, log: Log) -> float:
        """Force everything reserved so far, wait for every in-flight
        durability round to retire, and surface deferred round errors.
        Returns the log's ``durable_vtime`` — the modelled time at which
        the drained prefix became durable (DESIGN.md §14), so benchmark
        loops read modelled latency from the same call that quiesces."""
        last = log.next_lsn - 1
        if last >= 1 and log.durable_lsn < last:
            log.force(last, freq=1)
        log.drain()
        return log.durable_vtime

    def _bound(self, log: Log, depth: int) -> Optional[int]:
        return None

    def _window(self, log: Log) -> Optional[int]:
        """Records that can be completed but not yet ISSUED at any
        instant — one policy window's span, the per-round term of the
        tightened bound (every issue leader covers everything completed
        up to its own LSN)."""
        return None

    def vulnerability_bound(self, log: Log) -> Optional[int]:
        """Worst-case completed-but-unforced records, computed against
        the pipeline-depth CEILING (cfg.pipeline_depth) — the promise
        that holds whatever the adaptive controller does."""
        return self._bound(log, log.cfg.pipeline_depth)

    def effective_vulnerability_bound(self, log: Log) -> Optional[int]:
        """Momentary exposure, tightened by per-round-span accounting.

        The static (depth+1)-multiplied formula charges a FULL policy
        window for every pipeline slot whether or not a round occupies
        it.  Decompose instead: completed-but-undurable =
        (completed − issued) + (issued − durable).  The first term is
        one policy window (a leader's issue covers everything completed
        up to its LSN, and with ``wait=False`` completing threads still
        block on a pipeline slot before racing further ahead); the
        second is ``log.inflight_span()`` — the rounds actually in
        flight, measured, not assumed maximal.  Capped by the static
        formula at the controller's CURRENT depth (DESIGN.md §9), so it
        also tightens whenever the controller backs off."""
        static = self._bound(log, log.pipeline_depth)
        window = self._window(log)
        if static is None or window is None:
            return static
        return min(static, window + log.inflight_span())


class SyncPolicy(ForcePolicy):
    name = "sync"

    def on_complete(self, log: Log, rec_id: int) -> None:
        log.force(rec_id, freq=1, wait=self.wait)

    def on_complete_batch(self, log: Log, lsns: List[int]) -> None:
        # forcing the last LSN covers the whole batch in one coalesced
        # persist+replicate round (in-order commit has no holes)
        if lsns:
            log.force(lsns[-1], freq=1, wait=self.wait)

    def _bound(self, log: Log, depth: int) -> Optional[int]:
        # with the non-blocking handoff, issued-but-unretired rounds sit
        # in the window (one per pipeline slot, each covering at most one
        # record per completing thread), plus completed records whose
        # issuing thread is blocked on a full pipeline
        if self.wait and depth == 1:
            return 0
        return depth + log.cfg.max_threads

    def _window(self, log: Log) -> Optional[int]:
        # at most one completed-but-unissued record per completing thread
        return log.cfg.max_threads


class GroupCommitPolicy(ForcePolicy):
    """Shared-counter group commit (the design the paper argues against).

    ``_count`` and its mutex are the contended cache line: every complete
    from every thread bounces it (Fig. 8b L1d misses).
    """

    name = "group"

    def __init__(self, group_size: int, wait: bool = True):
        super().__init__(wait)
        self.group_size = int(group_size)
        self._lock = threading.Lock()
        self._count = 0

    def on_complete(self, log: Log, rec_id: int) -> None:
        lead = False
        with self._lock:                 # the contended line
            self._count += 1
            if self._count >= self.group_size:
                self._count = 0
                lead = True
        if lead:
            log.force(rec_id, freq=1, wait=self.wait)

    def on_complete_batch(self, log: Log, lsns: List[int]) -> None:
        if not lsns:
            return
        lead = False
        with self._lock:                 # one acquisition per batch
            self._count += len(lsns)
            if self._count >= self.group_size:
                # keep the overshoot: a batch may cross the window
                # mid-way, and the remainder counts toward the next
                # force exactly as scalar on_complete calls would
                self._count %= self.group_size
                lead = True
        if lead:
            log.force(lsns[-1], freq=1, wait=self.wait)

    def _bound(self, log: Log, depth: int) -> Optional[int]:
        # window size + records racing in while the leader forces; with
        # pipelining (or non-blocking handoff) up to ``depth``
        # issued-but-unretired rounds extend the window, each covering
        # at most one such span
        base = self.group_size + log.cfg.max_threads
        if self.wait and depth == 1:
            return base
        return base * (depth + 1)

    def _window(self, log: Log) -> Optional[int]:
        # one counter window plus records racing in while it fills
        return self.group_size + log.cfg.max_threads


class FreqPolicy(ForcePolicy):
    """The paper's frequency-based policy: leaders are chosen by LSN
    arithmetic (lsn % F == 0) — zero shared state added."""

    name = "freq"

    def __init__(self, freq: int, wait: bool = True):
        super().__init__(wait)
        self.freq = int(freq)

    def on_complete(self, log: Log, rec_id: int) -> None:
        log.force(rec_id, freq=self.freq, wait=self.wait)

    def on_complete_batch(self, log: Log, lsns: List[int]) -> None:
        # the largest leader LSN in the batch covers every force the
        # scalar loop would have issued (in-order commit)
        leaders = [l for l in lsns if l % self.freq == 0]
        if leaders:
            log.force(leaders[-1], freq=self.freq, wait=self.wait)

    def _bound(self, log: Log, depth: int) -> Optional[int]:
        """F × T (§4.4) for the serial blocking engine; with pipelining
        or the non-blocking handoff, up to ``depth``
        issued-but-unretired rounds — each covering at most an F×T span
        — extend the worst case to (depth + 1) × F × T."""
        base = self.freq * log.cfg.max_threads
        if self.wait and depth == 1:
            return base
        return base * (depth + 1)

    def _window(self, log: Log) -> Optional[int]:
        # F×T (§4.4): the classic frequency window, per round span
        return self.freq * log.cfg.max_threads


def make_policy(name: str, *, freq: int = 8, group_size: int = 128,
                wait: bool = True) -> ForcePolicy:
    if name == "sync":
        return SyncPolicy(wait=wait)
    if name == "group":
        return GroupCommitPolicy(group_size, wait=wait)
    if name == "freq":
        return FreqPolicy(freq, wait=wait)
    raise ValueError(f"unknown force policy {name!r}")
