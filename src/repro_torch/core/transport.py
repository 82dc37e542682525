"""RDMA transport model: one-sided verbs against a remote PMEM device.

Models the paper's replication fabric (EDR InfiniBand, RDMA-Write-with-
Immediate) with the properties that matter for correctness and cost:

  * A ``write_imm`` transfers bytes and carries the length as the immediate
    value; the remote server uses the completion's address + immediate to
    run the *persistence primitive* and then acks with a Send.  One round
    trip total (§3, Replication Primitive).
  * Remote writes land in the remote server's *volatile* domain first (the
    NIC posts into CPU caches — DDIO), so remote persistence only holds
    after the remote-side force.  ``handle_write_imm`` performs both.
  * The NIC reads the source buffer by DMA: lines evicted from LLC by a
    prior local flush must be fetched from PMEM (Fig. 6 effect) —
    accounted by ``PMEMDevice.dma_read``.
  * Failures: a transport can be set to drop traffic (network partition /
    backup death ⇒ timeout) and servers can *fence* old primaries by epoch
    (§4.2 Handling Primary Failure).

All hardware waits are virtual ns (see ``CostModel``); data movement is
real (bytes really land in the backup's device) so recovery tests operate
on true content.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, \
    wait
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

from .pmem import CostModel, PMEMDevice
from .timeline import VirtualTimeline


class TransportError(Exception):
    """Timeout / partition / fencing failure on a transport."""


class QuorumError(Exception):
    """Fewer than W replicas acknowledged a forced write."""


class ReplicaServer:
    """A backup node: hosts one PMEM device and the write_imm handler."""

    def __init__(self, device: PMEMDevice, server_id: str):
        self.device = device
        self.server_id = server_id
        self._fenced: set[str] = set()
        self._epoch = 1
        self._lock = threading.Lock()

    # -- membership / fencing ------------------------------------------- #
    def fence(self, primary_id: str) -> None:
        """Close connections from an old primary (called on leader change)."""
        with self._lock:
            self._fenced.add(primary_id)

    def unfence(self, primary_id: str) -> None:
        """Re-admit ONE primary (backup rejoin after a transient fault).
        Epoch fences of deposed primaries stay up."""
        with self._lock:
            self._fenced.discard(primary_id)

    def unfence_all(self) -> None:
        with self._lock:
            self._fenced.clear()

    def set_epoch(self, epoch: int) -> None:
        with self._lock:
            self._epoch = epoch

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def is_fenced(self, primary_id: str) -> bool:
        with self._lock:
            return primary_id in self._fenced

    # -- verbs ------------------------------------------------------------ #
    def handle_write_imm(self, dst_off: int, data: bytes, primary_id: str) -> float:
        """RDMA-Write lands in the volatile domain; the immediate-value
        completion triggers the persistence primitive; then ack."""
        if self.is_fenced(primary_id):
            raise TransportError(
                f"{self.server_id}: primary {primary_id} is fenced off")
        vns = self.device.write(dst_off, data)       # NIC -> caches (volatile)
        vns += self.device.persist(dst_off, len(data))  # force to PMEM
        return vns

    def handle_read(self, off: int, n: int) -> Tuple[bytes, float]:
        data, vns = self.device.dma_read(off, n)
        return data, vns


@dataclass
class FailureSpec:
    """Failure injection for one transport."""

    drop: bool = False          # partition: all ops time out
    fail_after_ops: int = -1    # fail once op counter passes this (-1 = never)
    delay_s: float = 0.0        # straggler: wall-clock stall per op


@dataclass
class _StagedWrite:
    """Issue-side snapshot of one doorbell-batched write_imm.

    The NIC DMA-reads the source ranges at *post* time (before any later
    local flush can evict the lines — the REP_LF ordering of Fig. 6); the
    wire + remote-persistence half runs later on the transport's FIFO
    lane.  ``posted_at`` anchors injected wire latency to the doorbell
    post, so multiple in-flight WQEs on one QP overlap on the wire the
    way a real RC QP pipelines them (completions stay FIFO).
    """

    datas: List[Tuple[int, bytes]]
    total: int
    read_vns: float
    posted_at: float


class Transport:
    """A reliable-connection QP from the primary to one backup."""

    def __init__(self, server: ReplicaServer, primary_id: str,
                 cost: Optional[CostModel] = None,
                 timeout_ns: float = 1e9):
        self.server = server
        self.primary_id = primary_id
        self.cost = cost or CostModel()
        self.timeout_ns = timeout_ns
        self.failure = FailureSpec()
        self._ops = 0
        self._closed = False

    # -- failure control --------------------------------------------------- #
    def inject(self, **kw) -> None:
        self.failure = FailureSpec(**kw)

    def close(self) -> None:
        self._closed = True

    def reopen(self) -> None:
        """Reconnect to a recovered backup (§4.2 backup rejoin): clears
        the eviction and any failure injection.  The server's device
        keeps whatever it held when the connection died — the salvage
        path (DESIGN.md §9) or quorum repair closes the gap; fencing
        state stays with the server."""
        self.failure = FailureSpec()
        self._closed = False

    @property
    def closed(self) -> bool:
        return self._closed

    def _gate(self) -> None:
        self._ops += 1
        if self._closed:
            raise TransportError("transport closed")
        if self.failure.delay_s > 0:
            time.sleep(self.failure.delay_s)   # injected straggler stall
        if self.failure.drop:
            raise TransportError(f"timeout after {self.timeout_ns:.0f} vns "
                                 f"(partition to {self.server.server_id})")
        if 0 <= self.failure.fail_after_ops < self._ops:
            raise TransportError(
                f"backup {self.server.server_id} failed (injected)")

    # -- verbs ------------------------------------------------------------ #
    def write_imm(self, src_dev: PMEMDevice, src_off: int, dst_off: int,
                  n: int) -> float:
        """Replication primitive wire op: one round trip, remote force, ack.

        Returns virtual ns from posting the WQE to receiving the ack.
        """
        self._gate()
        data, read_vns = src_dev.dma_read(src_off, n)   # NIC DMA of source
        wire_vns = self.cost.rdma_rtt_ns + n * self.cost.rdma_byte_ns
        remote_vns = self.server.handle_write_imm(dst_off, data,
                                                  self.primary_id)
        return read_vns + wire_vns + remote_vns

    def write_imm_bytes(self, data: bytes, dst_off: int) -> float:
        """Same, but the source is a registered DRAM buffer (remote-only
        mode): no LLC-miss modelling on the source side."""
        self._gate()
        wire_vns = self.cost.rdma_rtt_ns + len(data) * self.cost.rdma_byte_ns
        remote_vns = self.server.handle_write_imm(dst_off, data,
                                                  self.primary_id)
        return wire_vns + remote_vns

    def write_imm_batch(self, src_dev: PMEMDevice,
                        segs: Sequence[Tuple[int, int]]) -> float:
        """Doorbell-batched replication: the scatter list of (off, n)
        ranges is posted as ONE WQE chain — one round trip on the wire —
        while the remote side runs the persistence primitive per range
        (identical remote DeviceStats to per-range write_imm)."""
        self._gate()
        vns = 0.0
        total = 0
        datas = []
        for off, n in segs:
            data, read_vns = src_dev.dma_read(off, n)   # NIC DMA per range
            vns += read_vns
            total += n
            datas.append((off, data))
        vns += self.cost.rdma_rtt_ns + total * self.cost.rdma_byte_ns
        for off, data in datas:
            vns += self.server.handle_write_imm(off, data, self.primary_id)
        return vns

    def post_write_imm_batch(self, src_dev: PMEMDevice,
                             segs: Sequence[Tuple[int, int]]) -> _StagedWrite:
        """Issue-side half of a doorbell-batched write_imm: admission gate
        (op accounting + partition/failure injection — everything except
        the straggler stall, which is wire time) plus the NIC DMA snapshot
        of the source ranges.  Raises TransportError here, at post time,
        if the transport is closed or partitioned; the caller treats that
        as this backup failing the round."""
        self._ops += 1
        if self._closed:
            raise TransportError("transport closed")
        if self.failure.drop:
            raise TransportError(f"timeout after {self.timeout_ns:.0f} vns "
                                 f"(partition to {self.server.server_id})")
        if 0 <= self.failure.fail_after_ops < self._ops:
            raise TransportError(
                f"backup {self.server.server_id} failed (injected)")
        datas: List[Tuple[int, bytes]] = []
        read_vns = 0.0
        total = 0
        for off, n in segs:
            data, vns = src_dev.dma_read(off, n)   # NIC DMA at post time
            datas.append((off, data))
            read_vns += vns
            total += n
        return _StagedWrite(datas, total, read_vns, time.monotonic())

    def write_imm_staged(self, staged: _StagedWrite) -> float:
        """Wire + remote half of a posted write_imm_batch (runs on the
        FIFO lane).  An injected straggler delay counts from the doorbell
        *post*, not from lane dequeue, so in-flight WQEs overlap on the
        wire while completions stay in order."""
        if self.failure.delay_s > 0:
            remaining = staged.posted_at + self.failure.delay_s \
                - time.monotonic()
            if remaining > 0:
                time.sleep(remaining)
        if self._closed:
            raise TransportError("transport closed")
        vns = staged.read_vns + self.cost.rdma_rtt_ns \
            + staged.total * self.cost.rdma_byte_ns
        for off, data in staged.datas:
            vns += self.server.handle_write_imm(off, data, self.primary_id)
        return vns

    def read(self, off: int, n: int) -> Tuple[bytes, float]:
        """One-sided RDMA Read (recovery/repair path)."""
        self._gate()
        data, remote_vns = self.server.handle_read(off, n)
        return data, self.cost.rdma_rtt_ns + n * self.cost.rdma_byte_ns + remote_vns

    def ping(self) -> float:
        """Zero-payload heartbeat probe (DESIGN.md §11 failure detector).

        Models a dedicated heartbeat QP sharing the physical path with
        the data lane: an injected partition / failure schedule /
        straggler stall fails or delays the probe exactly like a data
        verb, but the data lane's ``closed`` flag does NOT — eviction is
        a primary-side bookkeeping decision, and a recovered node must
        be detectable on the heartbeat session even though its old lane
        was torn down (the rejoin path reopens it).  Fencing does not
        fail pings either: epoch control is not liveness.  Probes leave
        the data lane's op counter alone so heartbeats never perturb a
        ``fail_after_ops`` schedule.  Returns the round-trip vns."""
        if self.failure.delay_s > 0:
            time.sleep(self.failure.delay_s)
        if self.failure.drop:
            raise TransportError(f"heartbeat timeout "
                                 f"(partition to {self.server.server_id})")
        if 0 <= self.failure.fail_after_ops < self._ops:
            raise TransportError(
                f"backup {self.server.server_id} failed (injected)")
        return self.cost.rdma_rtt_ns


@dataclass
class RoundSalvage:
    """The re-issuable remainder of one failed quorum round (§PR-5).

    Captures everything the next force leader needs to finish the round
    without repeating work that already landed: the byte ranges the
    round covered, which lanes acked (their copies are durable — their
    acks are re-credited if the backup is still live), which lanes never
    acked, and — for lanes whose doorbell was posted — the wire image
    the NIC DMA-snapshotted at post time, so the re-issue reads nothing
    from the device.  ``staged`` is None for a lane evicted at post time
    (nothing was snapshotted); a re-issue to such a lane must re-snapshot.
    """

    segs: List[Tuple[int, int]]                       # ranges the round covered
    total: int                                        # sum of range bytes
    local_vns: Optional[float]                        # local ack credit
    acked: List[Tuple["Transport", float]]            # lanes that acked
    pending: List[Tuple["Transport", Optional[_StagedWrite]]]  # never acked


class QuorumRound:
    """Handle for one issued (in-flight) quorum round.

    Returned by the ``*_async`` issue paths once the doorbell has been
    posted on every live lane.  ``result()`` blocks until the round
    settles: quorum met (returns the W-th smallest ack vns) or quorum
    arithmetically unreachable (raises QuorumError; a non-transport lane
    error is re-raised instead and un-stashed from the group's deferred
    list).  ``add_done_callback`` fires exactly once when the round
    settles — on the lane thread that settles it, or inline if already
    settled — which is what lets the log retire rounds without a
    dedicated retirement thread.

    Acks carry identity: the round records *which* lane acked (and which
    never did) alongside the vns figures, so a failed round can be
    ``salvage()``d — re-issued as only its unacked (backup × range)
    deltas instead of from scratch (DESIGN.md §9).
    """

    def __init__(self, group: "ReplicationGroup", write_quorum: int,
                 segs: Optional[Sequence[Tuple[int, int]]] = None):
        self._group = group
        self._w = write_quorum
        self._cv = threading.Condition()
        self._acks: List[float] = []
        self._outstanding = 0
        self._sealed = False
        self._fatal: Optional[BaseException] = None
        self._callbacks: List[Callable[[], None]] = []
        # per-lane ack identity (salvage bookkeeping)
        self.segs: List[Tuple[int, int]] = list(segs or [])
        self._local_vns: Optional[float] = None
        self._fut_lane: dict = {}                 # Future -> Transport
        self._lane_acked: List[Tuple[Transport, float]] = []
        self._lane_pending: dict = {}             # Transport -> _StagedWrite|None
        # timeline bookkeeping (DESIGN.md §14): the acks that counted
        # toward _acks, in arrival order, with lane identity (None =
        # local ack), and each posted lane's wire *occupancy* — the vns
        # the lane is busy (NIC source read + bytes on the wire) before
        # the RTT/remote-persist latency tail that does not occupy it.
        self._sched: List[Tuple[Optional[Transport], float]] = []
        self._lane_occ: dict = {}                 # Transport -> occupancy vns

    # -- issue-side wiring (group only) ---------------------------------- #
    def _ack_local(self, vns: float) -> None:
        self._local_vns = vns
        self._acks.append(vns)
        self._sched.append((None, vns))

    def _credit(self, t: "Transport", vns: float) -> None:
        """Bank a prior ack (a lane that acked the original round and is
        still live) without any wire traffic — with identity, so a
        failed re-issue can itself be salvaged without losing it."""
        with self._cv:
            self._acks.append(vns)
            self._lane_acked.append((t, vns))
            # no _lane_occ entry: a banked credit sends nothing on the
            # wire this round, so it is pure latency on the timeline
            self._sched.append((t, vns))

    def _note_acked(self, t: "Transport", vns: float) -> None:
        """A lane that acked the original round but is not live now: its
        copy exists but cannot count toward this round's quorum.  Keep
        the identity so the credit revives if the backup rejoins before
        a later salvage."""
        with self._cv:
            self._lane_acked.append((t, vns))

    def _track(self, fut: Future, t: Optional["Transport"] = None,
               staged: Optional[_StagedWrite] = None) -> None:
        with self._cv:
            self._outstanding += 1
            if t is not None:
                self._fut_lane[fut] = t
                self._lane_pending[t] = staged
        # added AFTER the group's _harvest callback, so by the time
        # _on_done runs, eviction / error stashing has been applied
        fut.add_done_callback(self._on_done)

    def _note_unposted(self, t: "Transport",
                       staged: Optional[_StagedWrite] = None) -> None:
        """A lane that failed at post time (or was already evicted): it
        never acked and has no wire image unless one was handed over."""
        with self._cv:
            self._lane_pending.setdefault(t, staged)

    def _set_occ(self, t: "Transport", occ: float) -> None:
        """Record a posted lane's wire occupancy (set at post time)."""
        with self._cv:
            self._lane_occ[t] = occ

    def _settled_locked(self) -> bool:
        return (len(self._acks) >= self._w
                or (self._sealed and len(self._acks) + self._outstanding
                    < self._w))

    def _fire_if_settled(self) -> None:
        with self._cv:
            if not self._settled_locked():
                return
            fire, self._callbacks = self._callbacks, []
            self._cv.notify_all()
        for cb in fire:
            cb()

    def _on_done(self, fut: Future) -> None:
        with self._cv:
            self._outstanding -= 1
            exc = fut.exception() if not fut.cancelled() else \
                TransportError("lane op cancelled")
            t = self._fut_lane.pop(fut, None)
            if exc is None:
                vns = fut.result()
                self._acks.append(vns)
                self._sched.append((t, vns))
                if t is not None:
                    self._lane_pending.pop(t, None)
                    self._lane_acked.append((t, vns))
            elif not isinstance(exc, TransportError) and self._fatal is None:
                self._fatal = exc
        self._fire_if_settled()

    def _seal(self) -> None:
        """All lanes posted: the ack universe is now fixed."""
        with self._cv:
            self._sealed = True
        self._fire_if_settled()

    # -- caller surface --------------------------------------------------- #
    def done(self) -> bool:
        with self._cv:
            return self._settled_locked()

    def salvage(self) -> RoundSalvage:
        """Snapshot the round's re-issuable remainder.

        Safe to call at any time; meaningful once the round has failed
        (an in-flight lane op still counts as *pending* — a late ack
        just means the re-issue sends a byte-identical duplicate, which
        the idempotent write_imm absorbs)."""
        with self._cv:
            return RoundSalvage(
                segs=list(self.segs),
                total=sum(n for _, n in self.segs),
                local_vns=self._local_vns,
                acked=list(self._lane_acked),
                pending=list(self._lane_pending.items()))

    def schedule_on(self, tl: VirtualTimeline, t_post: float) -> float:
        """Place this round's acks on the virtual timeline and return the
        modelled vtime at which the write quorum filled (DESIGN.md §14).

        ``t_post`` is the vtime the doorbells were posted.  Each counted
        ack becomes an interval: a lane ack occupies its wire resource
        for the post-time occupancy (NIC source read + bytes on the
        wire) and carries the rest of its vns (RTT + remote persist) as
        non-occupying latency, so back-to-back rounds overlap on the
        lane exactly as in-flight WQEs do on an RC QP.  Local acks and
        banked salvage credits sent nothing this round and are pure
        latency.  The quorum fills at the W-th smallest end.

        Lanes still in flight when the round retires are not scheduled
        (their clocks do not advance) — the same stragglers the legacy
        scalar model ignored.
        """
        with self._cv:
            sched = list(self._sched)
            occ = dict(self._lane_occ)
            w = self._w
        ends: List[float] = []
        for t, vns in sched:
            lane_occ = occ.get(t) if t is not None else None
            if lane_occ is None:
                ends.append(t_post + vns)
            else:
                iv = tl.schedule(f"wire:{t.server.server_id}",
                                 busy=lane_occ,
                                 latency=max(vns - lane_occ, 0.0),
                                 after=t_post)
                ends.append(iv.end)
        if not ends:
            return t_post
        ends.sort()
        return ends[w - 1] if len(ends) >= w else ends[-1]

    def add_done_callback(self, fn: Callable[[], None]) -> None:
        with self._cv:
            if not self._settled_locked():
                self._callbacks.append(fn)
                return
        fn()

    def result(self, timeout: Optional[float] = None) -> float:
        """W-th smallest ack vns; QuorumError if the quorum cannot fill;
        TimeoutError if the round has not settled within ``timeout``."""
        with self._cv:
            if not self._cv.wait_for(self._settled_locked, timeout):
                raise TimeoutError("quorum round still in flight")
            if len(self._acks) >= self._w:
                return sorted(self._acks)[self._w - 1]
            exc: BaseException = self._fatal if self._fatal is not None \
                else QuorumError(f"write quorum {self._w} not met "
                                 f"({len(self._acks)} acks)")
        if not isinstance(exc, QuorumError):
            # un-stash the harvest's copy so it doesn't re-raise on a
            # later unrelated call (same contract as the sync round)
            with self._group._pending_cv:
                try:
                    self._group._errors.remove(exc)
                except ValueError:
                    pass
        raise exc


class ReplicationGroup:
    """Primary-side fan-out to all backups with write-quorum semantics.

    Writes are issued to every live backup in parallel (the paper: "RDMA
    Writes are initiated to all backups in parallel"); completion is the
    W-th fastest ack — ``replicate`` returns as soon as W acks are in and
    harvests straggler completions in the background.  A timed-out/failed
    backup is evicted (connection closed) so a transient partition cannot
    leave an inconsistent backup attached (§4.2 Replication).

    Each transport gets its own single-worker lane, modelling the FIFO
    ordering of an RDMA reliable-connection QP: writes to one backup
    execute in submission order, so a straggler's late failure closes the
    transport *before* any later write on that lane runs — a backup can
    be behind, but it can never observe a gap.  (Future done-callbacks
    fire before the lane worker dequeues its next task, and a closed
    transport fails every queued op at the gate.)
    """

    def __init__(self, transports: List[Transport], write_quorum: int,
                 local_is_durable: bool = True):
        self.transports = list(transports)
        self.write_quorum = int(write_quorum)
        self.local_is_durable = bool(local_is_durable)
        n = self.n_replicas
        if not (0 < self.write_quorum <= n):
            raise ValueError(f"W={write_quorum} invalid for N={n}")
        self._lanes = {
            t: ThreadPoolExecutor(
                max_workers=1,
                thread_name_prefix=f"repl-{t.server.server_id}")
            for t in self.transports
        }
        # _pending tracks in-flight lane ops; an op leaves the set only
        # AFTER its harvest (eviction / error stash) has been applied, so
        # drain() observing an empty set implies all side effects landed.
        self._pending_cv = threading.Condition()
        self._pending: set[Future] = set()
        self._errors: List[BaseException] = []

    # N and R per §4.2: R + W > N  =>  R = N - W + 1
    @property
    def n_replicas(self) -> int:
        return len(self.transports) + (1 if self.local_is_durable else 0)

    @property
    def read_quorum(self) -> int:
        return self.n_replicas - self.write_quorum + 1

    def live_transports(self) -> List[Transport]:
        return [t for t in self.transports if not t.closed]

    # -- straggler bookkeeping -------------------------------------------- #
    def _submit(self, t: Transport,
                op: Callable[[Transport], float]) -> Future:
        fut = self._lanes[t].submit(op, t)
        with self._pending_cv:
            self._pending.add(fut)
        fut.add_done_callback(lambda f, t=t: self._harvest(t, f))
        return fut

    def _harvest(self, t: Transport, fut: Future) -> None:
        """Done-callback for every lane op: evict the backup on a (late)
        TransportError; stash anything else for the next caller.  The
        future leaves _pending only after those effects are applied."""
        if not fut.cancelled():
            exc = fut.exception()
            if isinstance(exc, TransportError):
                t.close()   # evict: avoids inconsistent half-attached backup
            elif exc is not None:
                with self._pending_cv:
                    self._errors.append(exc)
        with self._pending_cv:
            self._pending.discard(fut)
            self._pending_cv.notify_all()

    def _raise_deferred(self) -> None:
        """Surface the harvested straggler errors COALESCED: the whole
        backlog leaves at once, the oldest raises, and the rest ride on
        it as ``exc.pipe_backlog`` (same contract as the log's deferred
        pipeline errors) — one drain settles a storm of late lane
        failures instead of surfacing one error per call."""
        with self._pending_cv:
            if not self._errors:
                return
            errors, self._errors = self._errors, []
        exc = errors[0]
        exc.pipe_backlog = tuple(errors[1:])
        raise exc

    def drain(self, timeout: Optional[float] = None,
              surface_errors: bool = True) -> bool:
        """Wait until every in-flight straggler op has completed AND its
        harvest (eviction, error stash) has been applied, then surface
        any non-transport error a straggler raised.  Returns False if
        ``timeout`` expired with ops still in flight (their side effects
        have NOT all landed yet).  With ``surface_errors=False`` only
        the wait happens: stashed errors stay deferred for the next
        caller (failover drains use this so the signal is not lost)."""
        with self._pending_cv:
            snapshot = set(self._pending)
            drained = self._pending_cv.wait_for(
                lambda: not (snapshot & self._pending), timeout=timeout)
        if surface_errors:
            self._raise_deferred()
        return drained

    # -- quorum rounds ----------------------------------------------------- #
    def _quorum_round(self, op: Callable[[Transport], float],
                      local_ack_vns: Optional[float]) -> float:
        """Issue ``op`` on every live lane; return at the W-th ack.

        The returned figure is the W-th smallest ack vns among the acks
        collected when the quorum filled.  Stragglers keep running on
        their lanes and are harvested in the background (eviction on late
        TransportError happens before that lane's next op).  Raises
        QuorumError as soon as the quorum is arithmetically unreachable.
        """
        self._raise_deferred()
        acks: List[float] = []
        if self.local_is_durable and local_ack_vns is not None:
            acks.append(local_ack_vns)
        pending = {self._submit(t, op) for t in self.live_transports()}
        w = self.write_quorum
        while len(acks) < w:
            if len(acks) + len(pending) < w:
                raise QuorumError(
                    f"write quorum {w} not met "
                    f"({len(acks)}/{self.n_replicas} acks)")
            done, pending = wait(pending, return_when=FIRST_COMPLETED)
            for fut in done:
                exc = fut.exception()
                if exc is None:
                    acks.append(fut.result())
                elif not isinstance(exc, TransportError):
                    # programming error: never swallow — raise here, and
                    # un-stash the harvest's copy so it doesn't re-raise
                    # on a later unrelated call
                    with self._pending_cv:
                        self._pending_cv.wait_for(
                            lambda: fut not in self._pending, timeout=5.0)
                        try:
                            self._errors.remove(exc)
                        except ValueError:
                            pass
                    raise exc
        acks.sort()
        return acks[w - 1]

    def replicate(self, src_dev: PMEMDevice, src_off: int, dst_off: int,
                  n: int, local_ack_vns: float = 0.0) -> float:
        """Replicate+force [src_off, src_off+n) to every backup; wait for a
        write quorum of acks.  ``local_ack_vns`` is the completion time of
        the local durable copy (0 if none / already persisted).

        Returns the vns at which the W-th ack arrived.  Raises QuorumError
        if the quorum cannot be met; failed backups are evicted (at the
        latest, before the next replicate reuses their lane).
        """
        return self._quorum_round(
            lambda t: t.write_imm(src_dev, src_off, dst_off, n),
            local_ack_vns)

    def replicate_batch(self, src_dev: PMEMDevice,
                        segs: Sequence[Tuple[int, int]],
                        local_ack_vns: float = 0.0) -> float:
        """Replicate+force a scatter list of (off, n) ranges in ONE quorum
        round per backup (doorbell-batched write_imm): one wire round trip
        and one W-th-ack wait cover every range."""
        segs = list(segs)
        return self._quorum_round(
            lambda t: t.write_imm_batch(src_dev, segs), local_ack_vns)

    def replicate_batch_async(self, src_dev: PMEMDevice,
                              segs: Sequence[Tuple[int, int]],
                              local_ack_vns: Optional[float] = 0.0
                              ) -> QuorumRound:
        """Post one doorbell-batched replication round on every live lane
        and return immediately with a :class:`QuorumRound` handle.

        The NIC DMA snapshot of the source ranges happens here, at post
        time — before any subsequent local flush can evict the lines
        (the REP_LF ordering), and before the issuing thread moves on —
        so the issuing thread pays only the post; wire time and remote
        persistence complete on the FIFO lanes in the background.  A
        transport that fails its admission gate at post time is evicted
        on the spot and counts as a failed replica for this round.
        """
        segs = list(segs)
        self._raise_deferred()
        rnd = QuorumRound(self, self.write_quorum, segs=segs)
        if self.local_is_durable and local_ack_vns is not None:
            rnd._ack_local(local_ack_vns)
        for t in self.live_transports():
            try:
                staged = t.post_write_imm_batch(src_dev, segs)
            except TransportError:
                t.close()        # evict, exactly as the lane harvest would
                rnd._note_unposted(t)
                continue
            rnd._set_occ(t, staged.read_vns
                         + staged.total * t.cost.rdma_byte_ns)
            fut = self._submit(t, lambda tt, s=staged: tt.write_imm_staged(s))
            rnd._track(fut, t, staged)
        rnd._seal()
        return rnd

    def reissue_round_async(self, src_dev: PMEMDevice, salv: RoundSalvage
                            ) -> Tuple[QuorumRound, int]:
        """Finish a failed round by re-issuing only its unacked
        (backup × range) deltas (DESIGN.md §9).

        Lanes that acked the original round and are live again are
        credited without wire traffic (their copy is already durable);
        pending lanes that are live get the wire image the NIC snapshotted
        at the original post — no new device DMA — while a pending lane
        with no snapshot (evicted at post time) is re-snapshotted.  The
        caller is expected to have surfaced deferred group errors already
        (``reissue_segs`` does).  Returns (round, bytes actually re-sent).
        """
        rnd = QuorumRound(self, self.write_quorum, segs=salv.segs)
        if self.local_is_durable and salv.local_vns is not None:
            rnd._ack_local(salv.local_vns)
        live = set(self.live_transports())
        for t, vns in salv.acked:
            if t in live:
                rnd._credit(t, vns)
            else:
                rnd._note_acked(t, vns)
        # a lane the original round never reached (it was already evicted
        # at issue time) but which is live again now: it must receive the
        # ranges too, or a W that needs it can never fill — no snapshot
        # exists for it, so it takes the re-snapshot path below
        seen = {t for t, _ in salv.acked} | {t for t, _ in salv.pending}
        pending = list(salv.pending) + [(t, None) for t in live
                                        if t not in seen]
        posted_bytes = 0
        for t, staged in pending:
            if t not in live:
                rnd._note_unposted(t, staged)
                continue
            if staged is None:
                try:
                    staged = t.post_write_imm_batch(src_dev, salv.segs)
                except TransportError:
                    t.close()
                    rnd._note_unposted(t)
                    continue
            else:
                # refresh the post anchor (straggler delays count from the
                # doorbell); the DMA snapshot and its read cost were paid
                # at the original post — charge nothing again
                staged = _StagedWrite(staged.datas, staged.total, 0.0,
                                      time.monotonic())
            rnd._set_occ(t, staged.read_vns
                         + staged.total * t.cost.rdma_byte_ns)
            fut = self._submit(t, lambda tt, s=staged: tt.write_imm_staged(s))
            rnd._track(fut, t, staged)
            posted_bytes += staged.total
        rnd._seal()
        return rnd, posted_bytes

    def broadcast_bytes(self, data: bytes, dst_off: int) -> float:
        """Replicate a small DRAM buffer (superline updates, epoch bumps).
        Fans out over the lanes in parallel and completes at the W-th ack,
        like replicate."""
        return self._quorum_round(
            lambda t: t.write_imm_bytes(data, dst_off), 0.0)

    def shutdown(self) -> None:
        for lane in self._lanes.values():
            lane.shutdown(wait=False, cancel_futures=True)
