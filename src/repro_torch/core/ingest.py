"""Multi-producer group-commit ingestion engine (DESIGN.md §10).

Concurrent ``append()`` calls from many client threads land in a
bounded submission queue; a single collector thread coalesces whatever
has queued into ONE ``reserve_batch`` + ``copy_batch`` +
``complete_batch`` and hands the wave to the force policy, slicing a
large wave across pipeline slots so its wire time overlaps with
itself.  A separate acker thread parks on the log's durable watermark
and acks each producer the moment its record's covering round retires
— per-record latency is the honest submit→durable-ack time, never a
batch average.

Admission control (the bounded front door):

  block — producers wait for queue space (backpressure; optional
          per-call timeout).
  fail  — a full queue raises IngestQueueFull immediately.
  shed  — a producer waits up to ``shed_deadline_s`` for space, then
          raises IngestShedError (deadline-based load shedding).
          Waiting producers are admitted strictly FIFO: freed slots go
          to the head of the wait queue, not to whichever thread wins
          the wakeup race, so one hot producer re-arriving in a tight
          loop cannot starve a slow one of queue slots (each producer
          has at most one append in flight, so FIFO over the waiters IS
          per-producer round-robin).

Single-producer fast path: on a local-durability log under sync-ack
semantics, an append that finds the engine completely idle (empty
queue, no wave being collected, nothing awaiting ack) skips the
collector handoff entirely — one scalar reserve/copy/complete plus a
blocking force on the producer's own thread.  The collector/acker hop
costs two thread switches per record, which caps a single producer at
a fraction of the scalar append path's throughput for zero batching
benefit (there is nothing to coalesce with); the fast path makes the
engine free when it cannot help.  The moment a second producer
overlaps, appends fall back to the queue and waves resume.

Both a record-count bound and a payload-byte budget apply, and bytes
are charged from submit until the wave is staged on the device
(``complete_batch``), so producer-visible memory stays O(queue bound):
at most one queue's worth waiting plus one in collection.

Flush triggers (when the collector closes a wave): queue size
(records or bytes), the oldest ticket's linger time, or a free
pipeline slot — the last one means a fast log degenerates to
"batch = arrivals during the previous wave's bookkeeping" (classic
group commit) while a congested pipeline accumulates bigger waves,
integrating with the adaptive-depth controller's current depth.

Ack semantics: a ticket that resolved without error is durable on a
write quorum (the producer may ack its own client).  A ticket that
resolved WITH an error makes no promise either way — conservative:
the record may still have become durable, but it was never acked,
matching the fault-matrix invariant that only *acked* records must
survive a crash.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, Iterator, List, Optional, Sequence

from .force_policy import ForcePolicy, SyncPolicy
from .log import Log, LogError


class IngestError(LogError):
    """Base class for ingestion front-end failures."""


class IngestQueueFull(IngestError):
    """fail-fast admission: the bounded queue had no room."""


class IngestShedError(IngestError):
    """shed admission: no queue space appeared within the shed deadline."""


class IngestClosedError(IngestError):
    """The engine was closed before the ticket could be accepted/acked."""


ADMISSION_MODES = ("block", "fail", "shed")


@dataclass
class IngestConfig:
    queue_records: int = 1024         # B: bounded submission queue (records)
    queue_bytes: int = 4 << 20        # max outstanding payload bytes
    admission: str = "block"          # block | fail | shed
    shed_deadline_s: float = 0.002    # shed: max wait for queue space
    flush_records: int = 512          # size trigger (records)
    flush_bytes: int = 1 << 20        # size trigger (payload bytes)
    flush_interval_s: float = 0.002   # time trigger: max linger of the
                                      # oldest queued ticket
    slice_bytes: int = 256 << 10      # large-wave slicing: one force per
                                      # <= this many payload bytes, so a
                                      # big wave spans pipeline slots
    direct_path: bool = True          # single-producer fast path (local
                                      # sync-ack logs only; see module
                                      # docstring)


def latency_percentiles(samples: Sequence[float],
                        pcts: Sequence[float] = (50.0, 99.0, 99.9),
                        ) -> Dict[str, float]:
    """Nearest-rank percentiles keyed "p50"/"p99"/"p999" (NaN if empty)."""
    s = sorted(samples)
    out: Dict[str, float] = {}
    for p in pcts:
        key = "p" + f"{p:g}".replace(".", "")
        if not s:
            out[key] = float("nan")
        else:
            idx = max(0, min(len(s) - 1, math.ceil(p / 100.0 * len(s)) - 1))
            out[key] = s[idx]
    return out


class IngestTicket:
    """One producer's submission: resolves to a durable LSN or an error.

    ``t_ack`` is the wall moment the record's covering durability round
    retired (``Log.durable_ack_time``) — not when the acker thread got
    around to it — so ``latency_s`` is record-level truth.
    """

    __slots__ = ("size", "lsn", "error", "t_submit", "t_ack",
                 "_data", "_ev")

    def __init__(self, data: bytes):
        self._data = data
        self._ev = threading.Event()   # per-ticket: no thundering herd
        self.size = len(data)
        self.lsn: Optional[int] = None
        self.error: Optional[BaseException] = None
        self.t_submit = time.monotonic()
        self.t_ack: Optional[float] = None

    @property
    def done(self) -> bool:
        return self._ev.is_set()

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.t_ack is None else self.t_ack - self.t_submit

    def wait(self, timeout: Optional[float] = None) -> int:
        """Block until the record's durable ack; returns its LSN.
        Raises the failure (QuorumError, admission error, closed) that
        prevented durability from being acknowledged."""
        if not self._ev.wait(timeout):
            raise IngestError(f"ticket wait timed out after {timeout}s")
        if self.error is not None:
            raise self.error
        assert self.lsn is not None
        return self.lsn


class IngestEngine:
    """The group-commit front door over one Log (see module docstring)."""

    def __init__(self, log: Log, cfg: Optional[IngestConfig] = None,
                 policy: Optional[ForcePolicy] = None):
        self.log = log
        self.cfg = cfg or IngestConfig()
        if self.cfg.admission not in ADMISSION_MODES:
            raise ValueError(
                f"admission must be one of {ADMISSION_MODES}, "
                f"got {self.cfg.admission!r}")
        # slices must land in successive pipeline slots, so the collector
        # forces with the non-blocking leader handoff whatever the
        # caller's policy waits for (producers get their blocking
        # semantics from the durable ack, not from the force call)
        base_policy = policy or SyncPolicy()
        self.policy = base_policy.nonblocking()
        # the direct fast path forces each record immediately, which is
        # only the caller's own durability cadence under sync semantics
        # — a freq/group policy's deliberately-unforced tail must stay
        # with the collector
        self._sync_ack = isinstance(base_policy, SyncPolicy)
        self._lock = threading.Lock()
        self._space = threading.Condition(self._lock)      # producers
        self._work = threading.Condition(self._lock)       # collector
        self._resolved = threading.Condition(self._lock)   # ticket/drain
        self._queue: Deque[IngestTicket] = deque()
        self._q_records = 0       # queued + in-collection records
        self._q_bytes = 0         # queued + in-collection payload bytes
        self._unacked: Deque[IngestTicket] = deque()   # LSN-assigned
        self._shed_fifo: Deque[object] = deque()   # fair-admission turns
        self._direct_lock = threading.Lock()       # fast path: 1 producer
        self._direct_inflight = 0
        self._producer_ident: Optional[int] = None  # first producer thread
        self._multi_producer = False  # latched when a 2nd thread appends
        self._collecting = False
        self._flush_asap = False  # drain(): close the current wave now
        self._closed = False
        self._ack_stop = False
        # counters (under _lock; exposed via stats())
        self.submitted = 0
        self.acked = 0
        self.failed = 0
        self.rejected = 0         # fail-fast refusals
        self.shed = 0             # shed-deadline refusals
        self.direct = 0           # fast-path records (no collector hop)
        self.waves = 0            # batches the collector committed
        self.forced_slices = 0
        self.max_wave_records = 0
        self.peak_queue_records = 0
        self.peak_queue_bytes = 0
        self._lat: Deque[float] = deque(maxlen=1 << 16)
        self._collector = threading.Thread(
            target=self._collect_loop, name="ingest-collector", daemon=True)
        self._acker = threading.Thread(
            target=self._ack_loop, name="ingest-acker", daemon=True)
        self._collector.start()
        self._acker.start()

    # -- admission -------------------------------------------------------- #
    def _fits_locked(self, size: int) -> bool:
        # an oversized single record is admitted into an empty queue
        # rather than deadlocking against the byte budget
        if self._closed:
            return True      # admission waits must wake up and fail
        if self._q_records == 0:
            return True
        return (self._q_records < self.cfg.queue_records
                and self._q_bytes + size <= self.cfg.queue_bytes)

    def append(self, data: bytes, timeout: Optional[float] = None
               ) -> IngestTicket:
        """Submit one record.  Returns immediately with an IngestTicket;
        call ``ticket.wait()`` for the durable ack.  Admission follows
        ``cfg.admission`` when the bounded queue is full; ``timeout``
        bounds a block-mode wait."""
        t = IngestTicket(bytes(data))
        cfg = self.cfg
        # "single producer" is latched by thread identity: the fast path
        # stays up only while every append so far came from one thread
        # (reset by drain(), which proves the engine idle again).  A
        # runtime-idle check alone is not enough — interleaved producers
        # can each find the engine momentarily idle and defeat batching.
        ident = threading.get_ident()
        if self._producer_ident is None:
            self._producer_ident = ident
        elif ident != self._producer_ident:
            self._multi_producer = True
        if cfg.direct_path and not self._multi_producer \
                and self._sync_ack and self.log.repl is None \
                and self._direct_append(t):
            return t
        with self._lock:
            if self._closed:
                raise IngestClosedError("ingest engine is closed")
            if not self._fits_locked(t.size):
                if cfg.admission == "fail":
                    self.rejected += 1
                    raise IngestQueueFull(
                        f"submission queue full "
                        f"({cfg.queue_records} records / "
                        f"{cfg.queue_bytes} bytes)")
                if cfg.admission == "shed":
                    # fair admission: take a turn token and wait for BOTH
                    # space and the head of the FIFO — a freed slot goes
                    # to the longest-waiting producer, never to whichever
                    # hot producer happens to win the wakeup race
                    token = object()
                    self._shed_fifo.append(token)
                    try:
                        ok = self._space.wait_for(
                            lambda: self._closed
                            or (self._shed_fifo[0] is token
                                and self._fits_locked(t.size)),
                            timeout=cfg.shed_deadline_s)
                    finally:
                        self._shed_fifo.remove(token)
                        # head turn passes on (admitted or timed out):
                        # wake the next waiter to claim it
                        self._space.notify_all()
                else:
                    ok = self._space.wait_for(
                        lambda: self._fits_locked(t.size), timeout=timeout)
                if self._closed:
                    raise IngestClosedError(
                        "ingest engine closed during admission")
                if not ok:
                    if cfg.admission == "shed":
                        self.shed += 1
                        raise IngestShedError(
                            f"no queue space within "
                            f"{cfg.shed_deadline_s * 1e3:.1f} ms shed "
                            f"deadline")
                    raise IngestError("block-mode admission timed out")
            self._queue.append(t)
            self._q_records += 1
            self._q_bytes += t.size
            self.submitted += 1
            if self._q_records > self.peak_queue_records:
                self.peak_queue_records = self._q_records
            if self._q_bytes > self.peak_queue_bytes:
                self.peak_queue_bytes = self._q_bytes
            self._work.notify()
        return t

    def _direct_append(self, t: IngestTicket) -> bool:
        """Single-producer fast path (see module docstring): if this
        producer is provably alone — nothing queued, no wave in
        collection, nothing awaiting ack, and no other direct append in
        flight — run the scalar reserve/copy/complete + blocking force
        inline and resolve the ticket before returning.  Returns False
        (caller takes the queue path) whenever any of that fails; the
        ticket resolves with the log error rather than raising, matching
        the wave path's ack semantics."""
        if not self._direct_lock.acquire(blocking=False):
            return False
        try:
            with self._lock:
                if (self._closed or self._queue or self._collecting
                        or self._unacked):
                    return False
                self._direct_inflight += 1
                self.submitted += 1
            lsn: Optional[int] = None
            error: Optional[BaseException] = None
            log = self.log
            try:
                rec_id, view = log.reserve(t.size)
                if view is not None:
                    view[:] = t._data
                else:
                    log.copy(rec_id, t._data)
                log.complete(rec_id)
                log.force(rec_id, freq=1, wait=True)
                lsn = rec_id
            except BaseException as exc:
                error = exc
            with self._lock:
                self._direct_inflight -= 1
                self.direct += 1
                if error is None:
                    t.lsn = lsn
                    t._data = b""
                    self._resolve_locked(t, t_ack=log.durable_ack_time(lsn))
                else:
                    self._resolve_locked(t, error=error)
                self._resolved.notify_all()
            return True
        finally:
            self._direct_lock.release()

    # -- collector -------------------------------------------------------- #
    def _flush_due_locked(self, first_t: float) -> bool:
        cfg = self.cfg
        return (self._closed
                or self._flush_asap
                or self._q_records >= cfg.flush_records
                or self._q_bytes >= cfg.flush_bytes
                or self.log.pipeline_free
                or time.monotonic() - first_t >= cfg.flush_interval_s)

    def _collect_loop(self) -> None:
        cfg = self.cfg
        while True:
            with self._lock:
                self._collecting = False
                self._resolved.notify_all()
                self._work.wait_for(lambda: self._queue or self._closed)
                if not self._queue:
                    return          # closed and fully flushed
                first_t = self._queue[0].t_submit
                while not self._flush_due_locked(first_t):
                    rem = cfg.flush_interval_s \
                        - (time.monotonic() - first_t)
                    self._work.wait(timeout=max(rem, 0.0002))
                tickets = list(self._queue)
                self._queue.clear()
                self._flush_asap = False
                self._collecting = True
            self._ingest_wave(tickets)

    def _ingest_wave(self, tickets: List[IngestTicket]) -> None:
        log = self.log
        n_bytes = sum(t.size for t in tickets)
        try:
            batch = log.reserve_batch([t.size for t in tickets])
            log.copy_batch(batch, [t._data for t in tickets])
            log.complete_batch(batch)
        except BaseException as exc:
            with self._lock:
                self._q_records -= len(tickets)
                self._q_bytes -= n_bytes
                for t in tickets:
                    self._resolve_locked(t, error=exc)
                self._space.notify_all()
                self._resolved.notify_all()
            return
        with self._lock:
            for t, lsn in zip(tickets, batch.lsns):
                t.lsn = lsn
                t._data = b""     # staged on device: release the payload
                self._unacked.append(t)
            self._q_records -= len(tickets)
            self._q_bytes -= n_bytes
            self.waves += 1
            if len(tickets) > self.max_wave_records:
                self.max_wave_records = len(tickets)
            self._space.notify_all()
        for lsns in self._slices(batch.lsns, batch.sizes):
            with self._lock:
                self.forced_slices += 1
            try:
                self.policy.on_complete_batch(log, lsns)
            except BaseException as exc:
                self._fail_unacked(exc)
                return
        # rounds that retired synchronously (local log, quorum filled
        # inline) get acked right here — no acker-thread hop in the
        # producers' resubmit path
        self._ack_ready()

    def _slices(self, lsns: List[int], sizes: List[int]
                ) -> Iterator[List[int]]:
        cap = max(1, self.cfg.slice_bytes)
        out: List[int] = []
        acc = 0
        for lsn, size in zip(lsns, sizes):
            out.append(lsn)
            acc += size
            if acc >= cap:
                yield out
                out, acc = [], 0
        if out:
            yield out

    # -- acker ------------------------------------------------------------ #
    def _resolve_locked(self, t: IngestTicket,
                        error: Optional[BaseException] = None,
                        t_ack: Optional[float] = None) -> None:
        if t._ev.is_set():
            return
        t.error = error
        t.t_ack = t_ack if t_ack is not None else time.monotonic()
        if error is None:
            self.acked += 1
            self._lat.append(t.t_ack - t.t_submit)
        else:
            self.failed += 1
        t._ev.set()

    def _ack_ready(self) -> None:
        """Resolve every LSN-assigned ticket the durable watermark
        already covers, stamping each with its round's retirement wall
        time.  The collector calls this right after forcing a wave —
        when the rounds retired synchronously (local log, or a quorum
        that filled inline) producers resubmit without waiting for the
        acker thread's wakeup hop — and the acker thread calls it on
        every watermark advance for the genuinely asynchronous case."""
        log = self.log
        d = log.durable_lsn
        with self._lock:
            if not self._unacked or self._unacked[0].lsn is None \
                    or self._unacked[0].lsn > d:
                return
            ready: List[IngestTicket] = []
            while self._unacked and self._unacked[0].lsn is not None \
                    and self._unacked[0].lsn <= d:
                ready.append(self._unacked.popleft())
            stamps = log.durable_ack_times([t.lsn for t in ready])
            for t, ts in zip(ready, stamps):
                self._resolve_locked(t, t_ack=ts)
            self._resolved.notify_all()

    def _fail_unacked(self, exc: BaseException) -> None:
        """A force/drain failure: ack every LSN-assigned ticket the
        durable watermark already covers, fail the rest.  Conservative
        by design — a failed ticket's record may still become durable
        later (e.g. via salvage), but it was never acked."""
        d = self.log.durable_lsn
        with self._lock:
            while self._unacked:
                t = self._unacked.popleft()
                if t.lsn is not None and t.lsn <= d:
                    self._resolve_locked(
                        t, t_ack=self.log.durable_ack_time(t.lsn))
                else:
                    self._resolve_locked(t, error=exc)
            self._resolved.notify_all()

    def _ack_loop(self) -> None:
        log = self.log
        last = -1
        stalled = 0
        while True:
            d = log.wait_durable_change(last, timeout=0.05)
            if d != last:
                last = d
                stalled = 0
                self._ack_ready()
                with self._lock:
                    # a retirement freed a pipeline slot: re-evaluate the
                    # collector's slot-free flush trigger
                    self._work.notify_all()
            else:
                stalled += 1
                if stalled >= 2:
                    stalled = 0
                    self._poke_stalled_pipeline()
            with self._lock:
                if self._ack_stop and not self._unacked:
                    return

    def _poke_stalled_pipeline(self) -> None:
        """Tickets are waiting but the watermark has stopped and the
        pipeline has gone idle: the collector's non-blocking forces never
        surface their round's failure, so it sits deferred in the log
        while every producer would otherwise ride out its own wait
        timeout.  Re-force the unacked tail — a salvageable failure gets
        its retry (bounded by the log's salvage retry budget), a
        permanent one surfaces here and fails the stranded tickets."""
        with self._lock:
            if not self._unacked:
                return
            tail = self._unacked[-1].lsn
        if self.log.stats()["inflight_rounds"]:
            return        # a round (e.g. a salvage retry) is still out
        try:
            self.log.force(tail, wait=False)
        except BaseException as exc:
            self._fail_unacked(exc)

    # -- lifecycle -------------------------------------------------------- #
    def drain(self, timeout: float = 30.0) -> None:
        """Flush and settle everything submitted so far: on return every
        ticket accepted before the call has been acked durable or failed
        — drain() never strands a producer.  Raises the first force
        error after failing the tickets it stranded; raises IngestError
        on timeout (still no hang)."""
        deadline = time.monotonic() + timeout

        def rem() -> float:
            return max(0.0, deadline - time.monotonic())

        with self._lock:
            self._flush_asap = True
            self._work.notify_all()
            ok = self._resolved.wait_for(
                lambda: not self._queue and not self._collecting,
                timeout=rem())
        if not ok:
            raise IngestError("drain timed out waiting for the collector")
        try:
            self.policy.drain(self.log)
        except BaseException as exc:
            self._fail_unacked(exc)
            raise
        with self._lock:
            ok = self._resolved.wait_for(
                lambda: not self._unacked and not self._direct_inflight,
                timeout=rem())
            if ok:
                # the engine is provably idle: re-arm the single-producer
                # latch so a post-drain phase can earn the fast path back
                self._producer_ident = None
                self._multi_producer = False
        if not ok:
            raise IngestError("drain timed out waiting for durable acks")

    def close(self, timeout: float = 30.0) -> None:
        """Flush, then shut the front door: blocked producers raise
        IngestClosedError, stragglers are acked or failed, threads
        joined.  Idempotent."""
        with self._lock:
            if self._closed:
                return
        try:
            self.drain(timeout=timeout)
        except BaseException:
            pass          # stranded tickets were already failed
        with self._lock:
            self._closed = True
            self._space.notify_all()
            self._work.notify_all()
        self._collector.join(timeout=timeout)
        self._fail_unacked(IngestClosedError("ingest engine closed"))
        self._ack_stop = True
        self._acker.join(timeout=timeout)
        with self._lock:
            for t in self._queue:     # raced in between drain and close
                self._resolve_locked(
                    t, error=IngestClosedError("ingest engine closed"))
            self._queue.clear()
            self._q_records = 0
            self._q_bytes = 0
            self._resolved.notify_all()

    # -- observability ---------------------------------------------------- #
    @property
    def busy(self) -> bool:
        """True while producer work is queued, being collected, or
        awaiting its durable ack — the load signal the background
        scrubber (health.Scrubber) backs off on so maintenance reads
        never compete with a hot ingest path."""
        with self._lock:
            return bool(self._queue or self._collecting or self._unacked
                        or self._direct_inflight)

    def latencies(self) -> List[float]:
        """Per-record submit→durable-ack seconds (most recent 64Ki)."""
        with self._lock:
            return list(self._lat)

    def latency_percentiles(self, pcts: Sequence[float] = (50.0, 99.0, 99.9)
                            ) -> Dict[str, float]:
        return latency_percentiles(self.latencies(), pcts)

    def stats(self) -> dict:
        with self._lock:
            return dict(submitted=self.submitted, acked=self.acked,
                        failed=self.failed, rejected=self.rejected,
                        shed=self.shed, direct=self.direct,
                        waves=self.waves,
                        forced_slices=self.forced_slices,
                        max_wave_records=self.max_wave_records,
                        peak_queue_records=self.peak_queue_records,
                        peak_queue_bytes=self.peak_queue_bytes,
                        queued=self._q_records,
                        unacked=len(self._unacked))
