"""The paper's four PMEM access primitives (§3).

  persistence  — ``PMEMDevice.persist`` (clwb loop + sfence), re-exported
                 here as ``persist`` for symmetry.
  replication  — ``write_and_force``: one-round-trip replicate + remote
                 force + local flush, with the three flush orderings
                 studied in Fig. 6 (parallel / LF+Rep / Rep+LF).
  integrity    — ``IntegrityRegion``: header+payload checksums; tolerates
                 torn writes and media errors with NO ordering or
                 atomicity requirements (Listing 1 / Fig. 1).
  atomicity    — ``AtomicRegion``: copy-on-write double buffer + index
                 flip for fixed-location objects (Listing 2 / Fig. 2).

Every mutating call returns virtual ns so benchmarks can report modelled
hardware latency alongside measured software cost.
"""

from __future__ import annotations

import struct
import threading
import zlib
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

from .pmem import CostModel, PMEMDevice
from .timeline import VirtualTimeline
from .transport import (QuorumError, QuorumRound, ReplicationGroup,
                        RoundSalvage)

crc32 = zlib.crc32

# Flush orderings for replicated persistence (Fig. 6).
PARALLEL = "parallel"   # local flush concurrent with replication
LF_REP = "lf+rep"       # local flush first, then replicate
REP_LF = "rep+lf"       # replicate first, then local flush (paper's winner)
ORDERINGS = (PARALLEL, LF_REP, REP_LF)


def persist(dev: PMEMDevice, off: int, n: int) -> float:
    """Persistence primitive: make [off, off+n) durable on local PMEM."""
    return dev.persist(off, n)


def write_and_force(
    dev: PMEMDevice,
    off: int,
    n: int,
    repl: Optional[ReplicationGroup] = None,
    ordering: str = REP_LF,
    local_durable: bool = True,
) -> float:
    """Replication primitive: make [off, off+n) durable on a write quorum.

    ``dev`` holds the already-written bytes (volatile is fine — the NIC
    snoops caches).  Ordering controls local-flush vs replication per the
    Fig. 6 study; REP_LF is the default because replicating first lets the
    NIC read source lines from LLC before the flush evicts them.
    """
    if repl is None:
        return dev.persist(off, n) if local_durable else 0.0
    if not repl.live_transports():
        vns = dev.persist(off, n) if local_durable else 0.0
        if repl.write_quorum > (1 if repl.local_is_durable else 0):
            raise QuorumError("no live backups and local copy alone cannot "
                              f"meet W={repl.write_quorum}")
        return vns

    if ordering == REP_LF:
        rep_vns = repl.replicate(dev, off, off, n, local_ack_vns=0.0)
        loc_vns = dev.persist(off, n) if local_durable else 0.0
        return rep_vns + loc_vns
    if ordering == LF_REP:
        loc_vns = dev.persist(off, n) if local_durable else 0.0
        rep_vns = repl.replicate(dev, off, off, n, local_ack_vns=loc_vns)
        return loc_vns + rep_vns
    if ordering == PARALLEL:
        # Flush and replication race, but the flush invalidates the LLC
        # lines under the NIC, so the DMA read effectively serializes
        # behind the writeback (same misses as LF+Rep) *plus* concurrent
        # read/write contention on the DIMM — the paper measures parallel
        # as the worst ordering (Fig. 6a/b).
        loc_vns = dev.persist(off, n) if local_durable else 0.0
        rep_vns = repl.replicate(dev, off, off, n, local_ack_vns=loc_vns)
        contention = 0.1 * min(loc_vns, rep_vns)
        return loc_vns + rep_vns + contention
    raise ValueError(f"unknown ordering {ordering!r}")


def write_and_force_segs(
    dev: PMEMDevice,
    segs,
    repl: Optional[ReplicationGroup] = None,
    ordering: str = REP_LF,
    local_durable: bool = True,
) -> float:
    """Replication primitive over a scatter list of (off, n) ranges.

    One doorbell-batched ``replicate_batch`` round covers every range —
    one wire round trip and one W-th-ack quorum wait for the whole list —
    while the local flushes run per range (the same clwb+sfence sequence
    the per-range path issues, so local DeviceStats are unchanged).  For
    a single range this is cost- and stat-identical to write_and_force;
    the log's force path uses it so a ring-wrap (two segments) no longer
    pays two quorum rounds.
    """
    segs = [(off, n) for off, n in segs]
    if not segs:
        return 0.0
    if len(segs) == 1 or repl is None or not repl.live_transports():
        vns = 0.0
        if repl is None:
            for off, n in segs:
                vns += dev.persist(off, n) if local_durable else 0.0
            return vns
        if not repl.live_transports():
            for off, n in segs:
                vns += dev.persist(off, n) if local_durable else 0.0
            if repl.write_quorum > (1 if repl.local_is_durable else 0):
                raise QuorumError("no live backups and local copy alone "
                                  f"cannot meet W={repl.write_quorum}")
            return vns
        off, n = segs[0]
        return write_and_force(dev, off, n, repl, ordering,
                               local_durable=local_durable)

    def _persist_all() -> float:
        if not local_durable:
            return 0.0
        return sum(dev.persist(off, n) for off, n in segs)

    if ordering == REP_LF:
        rep_vns = repl.replicate_batch(dev, segs, local_ack_vns=0.0)
        return rep_vns + _persist_all()
    if ordering == LF_REP:
        loc_vns = _persist_all()
        return loc_vns + repl.replicate_batch(dev, segs,
                                              local_ack_vns=loc_vns)
    if ordering == PARALLEL:
        loc_vns = _persist_all()
        rep_vns = repl.replicate_batch(dev, segs, local_ack_vns=loc_vns)
        return loc_vns + rep_vns + 0.1 * min(loc_vns, rep_vns)
    raise ValueError(f"unknown ordering {ordering!r}")


@dataclass
class ForceRound:
    """Handle for one issued ``write_and_force_segs_async`` round.

    ``wait()`` blocks until the round's write quorum settles and returns
    the round's modelled cost.  Cost model (DESIGN.md §8-9): a round that
    rides the async machinery pays the doorbell issue gap, and whatever
    genuinely overlaps is charged as a max, not a sum —

      REP_LF    max(wire, flush) + doorbell   — the flush runs after the
                post and overlaps wire time; the post-time DMA snapshot
                keeps the NIC's LLC hits.
      LF_REP    flush + wire + doorbell       — the ordering *requires*
                the flush to retire before the doorbell, so the serial
                sum is the model, not an accounting artifact.
      PARALLEL  max(wire, flush) + contention + doorbell — flush and wire
                race; the engine orders the flush before the post only so
                the DMA snapshot sees the same LLC evictions the real
                race loses (Fig. 6), but latency-wise the two overlap,
                plus the measured read/write DIMM contention penalty.
    """

    round: Optional[QuorumRound]       # None => no wire work was needed
    loc_vns: float = 0.0
    issue_vns: float = 0.0
    ordering: str = REP_LF

    def done(self) -> bool:
        return self.round is None or self.round.done()

    def add_done_callback(self, fn) -> None:
        if self.round is None:
            fn()
        else:
            self.round.add_done_callback(fn)

    def salvage_states(self) -> List[RoundSalvage]:
        """Re-issuable remainder(s) of this round (empty when the round
        needed no wire work — there is nothing to salvage locally)."""
        if self.round is None:
            return []
        return [self.round.salvage()]

    def wait(self, timeout: Optional[float] = None) -> float:
        if self.round is None:
            return self.loc_vns
        rep_vns = self.round.result(timeout)
        if self.ordering == REP_LF:
            return max(rep_vns, self.loc_vns) + self.issue_vns
        if self.ordering == LF_REP:
            return self.loc_vns + rep_vns + self.issue_vns
        return max(rep_vns, self.loc_vns) \
            + 0.1 * min(self.loc_vns, rep_vns) + self.issue_vns

    def schedule_on(self, tl: VirtualTimeline, after: float) -> float:
        """Place this settled round on the virtual timeline and return its
        modelled completion vtime (DESIGN.md §14).

        ``after`` is the round's dependency horizon (its pipeline slot
        became free).  Resources: the leader CPU pays the doorbell, the
        device flush port pays the local flush, the per-lane wires pay
        the quorum (``QuorumRound.schedule_on``).  The ordering decides
        the dependency edges exactly as ``wait()`` decides the scalar
        combine; with one round in flight at a time every resource clock
        is ≤ ``after`` when the round starts, so the interval end reduces
        to ``after + wait()`` — the depth=1 equivalence the tests pin.
        """
        if self.round is None:
            if self.loc_vns:
                return tl.schedule("flush", busy=self.loc_vns,
                                   after=after).end
            return after
        if self.ordering == REP_LF:
            t_post = tl.schedule("cpu", busy=self.issue_vns,
                                 after=after).busy_until
            flush_end = t_post
            if self.loc_vns:
                flush_end = tl.schedule("flush", busy=self.loc_vns,
                                        after=t_post).end
            q_end = self.round.schedule_on(tl, t_post)
            return max(q_end, flush_end)
        if self.ordering == LF_REP:
            flush_end = after
            if self.loc_vns:
                flush_end = tl.schedule("flush", busy=self.loc_vns,
                                        after=after).end
            t_post = tl.schedule("cpu", busy=self.issue_vns,
                                 after=flush_end).busy_until
            return self.round.schedule_on(tl, t_post)
        # PARALLEL: flush and wire race from the doorbell; the measured
        # DIMM read/write contention penalty rides on top (Fig. 6).
        t_post = tl.schedule("cpu", busy=self.issue_vns,
                             after=after).busy_until
        flush_rel = 0.0
        if self.loc_vns:
            flush_rel = tl.schedule("flush", busy=self.loc_vns,
                                    after=t_post).end - t_post
        rep_rel = self.round.schedule_on(tl, t_post) - t_post
        return t_post + max(rep_rel, flush_rel) \
            + 0.1 * min(self.loc_vns, rep_rel)


def write_and_force_segs_async(
    dev: PMEMDevice,
    segs,
    repl: Optional[ReplicationGroup] = None,
    ordering: str = REP_LF,
    local_durable: bool = True,
) -> ForceRound:
    """Issue-side half of the replication primitive: post the doorbell,
    run the (overlapping) local flush, and return a :class:`ForceRound`
    immediately — the wire round trip and the W-th-ack wait complete in
    the background on the per-transport FIFO lanes.

    This is the building block of the log's pipelined force engine: the
    issuing thread never blocks on wire time, so multiple durability
    rounds can be in flight at once.  With no replication group (or no
    live backups) the round is complete by the time this returns and
    ``wait()`` is free; the local flush sequence — and therefore the
    local DeviceStats — is identical to the synchronous primitive.
    """
    segs = [(off, n) for off, n in segs if n > 0]

    def _persist_all() -> float:
        if not local_durable:
            return 0.0
        return sum(dev.persist(off, n) for off, n in segs)

    if not segs:
        return ForceRound(None, 0.0, ordering=ordering)
    if repl is None:
        return ForceRound(None, _persist_all(), ordering=ordering)
    if not repl.live_transports():
        loc_vns = _persist_all()
        if repl.write_quorum > (1 if repl.local_is_durable else 0):
            raise QuorumError("no live backups and local copy alone cannot "
                              f"meet W={repl.write_quorum}")
        return ForceRound(None, loc_vns, ordering=ordering)

    if ordering == REP_LF:
        rnd = repl.replicate_batch_async(dev, segs, local_ack_vns=0.0)
        loc_vns = _persist_all()       # overlaps the wire time
        return ForceRound(rnd, loc_vns, issue_vns=dev.cost.doorbell_ns,
                          ordering=REP_LF)
    if ordering in (LF_REP, PARALLEL):
        loc_vns = _persist_all()
        rnd = repl.replicate_batch_async(dev, segs, local_ack_vns=loc_vns)
        return ForceRound(rnd, loc_vns, issue_vns=dev.cost.doorbell_ns,
                          ordering=ordering)
    raise ValueError(f"unknown ordering {ordering!r}")


# ---------------------------------------------------------------------- #
# Partial-quorum salvage (DESIGN.md §9)
# ---------------------------------------------------------------------- #
class SalvageForceRound:
    """ForceRound-compatible handle over the re-issued remainders of one
    or more failed durability rounds, optionally bundled with the issuing
    leader's own fresh range.

    Each failed round keeps its own write-quorum arithmetic (prior acks
    from still-live lanes are credited; only never-acked lanes get wire
    traffic), and the combined handle settles when EVERY constituent
    round — salvage and fresh alike — has settled: the pipelined force
    engine retires it like any other round, so the durable watermark
    still advances over a gapless prefix only.  Bundling the fresh range
    into the SAME pipeline round is what makes leader progress past an
    unresolved hole impossible: the fresh bytes cannot become durable
    unless the salvaged bytes ahead of them do.  ``wait()`` returns the
    max of the constituent costs (they overlap on the wire) plus the
    doorbell gap; no local flush is charged for the salvaged ranges —
    the failed rounds already persisted them at their original issue
    (the fresh part pays its own flush as usual).
    """

    def __init__(self, rounds: List[QuorumRound], reissue_bytes: int,
                 issue_vns: float = 0.0,
                 fresh: Optional["ForceRound"] = None):
        self.rounds = rounds
        self.reissue_bytes = reissue_bytes
        self.issue_vns = issue_vns
        self.fresh = fresh
        self._lock = threading.Lock()

    def _parts(self) -> list:
        return self.rounds + ([self.fresh] if self.fresh is not None else [])

    def done(self) -> bool:
        return all(p.done() for p in self._parts())

    def add_done_callback(self, fn) -> None:
        parts = self._parts()
        if not parts:
            fn()
            return
        remaining = [len(parts)]

        def _one_settled() -> None:
            with self._lock:
                remaining[0] -= 1
                last = remaining[0] == 0
            if last:
                fn()

        for p in parts:
            p.add_done_callback(_one_settled)

    def salvage_states(self) -> List[RoundSalvage]:
        """One state per salvaged round, plus — when a fresh range rode
        along — one trailing state for it (the caller re-stashes that as
        a new salvageable segment)."""
        states = [r.salvage() for r in self.rounds]
        if self.fresh is not None:
            states.extend(self.fresh.salvage_states())
        return states

    def wait(self, timeout: Optional[float] = None) -> float:
        vns = 0.0
        for r in self.rounds:
            vns = max(vns, r.result(timeout))
        if self.fresh is not None:
            vns = max(vns, self.fresh.wait(timeout))
        return vns + self.issue_vns

    def schedule_on(self, tl: VirtualTimeline, after: float) -> float:
        """Timeline placement of the bundled salvage round: one doorbell
        on the leader CPU covers the delta posts, then every constituent
        round (and the bundled fresh range, which pays its own doorbell
        and flush) runs from that post in parallel; the bundle completes
        at the latest constituent end.  Credited acks schedule as pure
        latency — no wire occupancy — because nothing was re-sent."""
        t_post = tl.schedule("cpu", busy=self.issue_vns,
                             after=after).busy_until
        end = t_post
        for r in self.rounds:
            end = max(end, r.schedule_on(tl, t_post))
        if self.fresh is not None:
            end = max(end, self.fresh.schedule_on(tl, t_post))
        return end


def reissue_segs(
    dev: PMEMDevice,
    salvages: Sequence[RoundSalvage],
    repl: Optional[ReplicationGroup],
    ordering: str = REP_LF,
    local_durable: bool = True,
    fresh_segs=None,
) -> SalvageForceRound:
    """Re-issue the unacked (backup × range) deltas of failed rounds.

    The MOD-style minimal re-issue: instead of replaying each failed
    round's whole range to every backup, post — per backup — only the
    ranges that backup never acked, reusing the wire images the NIC
    DMA-snapshotted at the original post.  Local PMEM is NOT re-flushed
    (the original issue already persisted the range; ``local_vns``
    credit inside each salvage carries the local ack), so a salvage
    round leaves the primary's DeviceStats exactly where a fault-free
    run would.

    ``fresh_segs``: the issuing leader's own un-issued range, bundled
    behind the salvage posts as one more constituent round (posted after
    the deltas, so every FIFO lane still sees LSN order).  It goes
    through the ordinary ``write_and_force_segs_async`` path — local
    flush and all — exactly as it would have with no stash in front.
    """
    def _fresh() -> Optional[ForceRound]:
        if not fresh_segs:
            return None
        return write_and_force_segs_async(dev, fresh_segs, repl, ordering,
                                          local_durable=local_durable)

    if repl is None:
        # replication was torn down since the failure: every salvaged
        # range is already durable locally; only the fresh part has work
        return SalvageForceRound([], 0, fresh=_fresh())
    repl._raise_deferred()
    rounds: List[QuorumRound] = []
    posted = 0
    for salv in salvages:
        rnd, nbytes = repl.reissue_round_async(dev, salv)
        rounds.append(rnd)
        posted += nbytes
    issue_vns = dev.cost.doorbell_ns if posted else 0.0
    return SalvageForceRound(rounds, posted, issue_vns=issue_vns,
                             fresh=_fresh())


# ---------------------------------------------------------------------- #
# Integrity primitive (Listing 1)
# ---------------------------------------------------------------------- #
#
# Layout (Fig. 1):   | size u32 | tag u32 | hdr_crc u32 | data[size] | crc u32 |
#
_HDR = struct.Struct("<III")        # size, tag, hdr_crc
_CRC = struct.Struct("<I")


@dataclass
class IntegrityRegion:
    """Reliably write-once / read data at a fixed PMEM offset.

    No write ordering, fencing between fields, or atomicity is required:
    a torn write is caught by one of the two checksums at read time.
    """

    dev: PMEMDevice
    off: int
    capacity: int                     # max payload bytes
    repl: Optional[ReplicationGroup] = None
    ordering: str = REP_LF

    HEADER_SIZE = _HDR.size

    def total_size(self) -> int:
        return self.HEADER_SIZE + self.capacity + _CRC.size

    def reliable_write(self, data: bytes, tag: int = 0) -> float:
        if len(data) > self.capacity:
            raise ValueError("payload exceeds region capacity")
        hdr_wo_crc = struct.pack("<II", len(data), tag)
        hdr = hdr_wo_crc + _CRC.pack(crc32(hdr_wo_crc))
        vns = self.dev.write(self.off, hdr)
        vns += self.dev.write(self.off + self.HEADER_SIZE, data)
        vns += self.dev.write(self.off + self.HEADER_SIZE + len(data),
                              _CRC.pack(crc32(data)))
        # ONE replicate+force covers header, payload, and CRC (no barriers).
        n = self.HEADER_SIZE + len(data) + _CRC.size
        vns += write_and_force(self.dev, self.off, n, self.repl, self.ordering)
        return vns

    def reliable_read(self) -> Tuple[Optional[bytes], int]:
        """Returns (payload | None-if-corrupt, tag). Header CRC is checked
        before the size field is trusted (§3: header first)."""
        raw = self.dev.read(self.off, self.HEADER_SIZE)
        size, tag, hcrc = _HDR.unpack(raw)
        if crc32(raw[:8]) != hcrc or size > self.capacity:
            return None, 0
        body = self.dev.read(self.off + self.HEADER_SIZE, size + _CRC.size)
        data, (dcrc,) = body[:size], _CRC.unpack(body[size:])
        if crc32(data) != dcrc:
            return None, tag
        return data, tag


# ---------------------------------------------------------------------- #
# Atomicity primitive (Listing 2)
# ---------------------------------------------------------------------- #
#
# Layout (Fig. 2):   | idx u64 | buf0: data[size] crc u32 pad | buf1: ... |
#
_IDX = struct.Struct("<Q")


class AtomicRegion:
    """Atomically update a fixed-size object at a fixed PMEM location.

    Copy-on-write into the non-current buffer, force, then flip + force the
    index — torn writes can only hit the inactive buffer.  With
    ``volatile_index=True`` the index lives in DRAM (the paper's
    optimization); recovery picks the valid buffer via a caller-supplied
    ``chooser`` over the decoded candidates (Arcadia uses max start-LSN).
    """

    def __init__(self, dev: PMEMDevice, off: int, size: int,
                 repl: Optional[ReplicationGroup] = None,
                 ordering: str = REP_LF,
                 volatile_index: bool = False):
        self.dev = dev
        self.off = off
        self.size = int(size)
        self.repl = repl
        self.ordering = ordering
        self.volatile_index = volatile_index
        self._vidx = 0  # DRAM copy of the index

    @property
    def _buf_stride(self) -> int:
        # pad to an 8-byte unit so buffers never share an atomic unit
        raw = self.size + _CRC.size
        return (raw + 7) // 8 * 8

    def total_size(self) -> int:
        return 8 + 2 * self._buf_stride

    def _buf_off(self, idx: int) -> int:
        return self.off + 8 + idx * self._buf_stride

    def _read_idx(self) -> int:
        if self.volatile_index:
            return self._vidx
        (v,) = _IDX.unpack(self.dev.read(self.off, 8))
        return int(v & 1)

    def atomic_write(self, data: bytes) -> float:
        if len(data) != self.size:
            raise ValueError(f"atomic region holds exactly {self.size} bytes")
        cur = self._read_idx()
        nxt = cur ^ 1
        boff = self._buf_off(nxt)
        vns = self.dev.write(boff, data)
        vns += self.dev.write(boff + self.size, _CRC.pack(crc32(data)))
        vns += write_and_force(self.dev, boff, self.size + _CRC.size,
                               self.repl, self.ordering)
        if self.volatile_index:
            self._vidx = nxt
        else:
            vns += self.dev.write(self.off, _IDX.pack(nxt))
            vns += write_and_force(self.dev, self.off, 8, self.repl,
                                   self.ordering)
        return vns

    def _read_buf(self, idx: int) -> Optional[bytes]:
        boff = self._buf_off(idx)
        raw = self.dev.read(boff, self.size + _CRC.size)
        data, (dcrc,) = raw[: self.size], _CRC.unpack(raw[self.size:])
        if crc32(data) != dcrc:
            return None
        return data

    def atomic_read(self) -> Optional[bytes]:
        return self._read_buf(self._read_idx())

    def recover(self, chooser: Optional[Callable[[bytes], int]] = None
                ) -> Optional[bytes]:
        """Re-derive the valid buffer after a crash.

        With a persistent index: trust it (its flip was forced after the
        data).  With a volatile index: decode both buffers, drop corrupt
        ones, and pick the one ``chooser`` scores highest (ties -> buf 0).
        """
        if not self.volatile_index:
            return self.atomic_read()
        cands = [(i, self._read_buf(i)) for i in (0, 1)]
        cands = [(i, d) for i, d in cands if d is not None]
        if not cands:
            return None
        if chooser is None:
            i, d = cands[-1]
        else:
            i, d = max(cands, key=lambda t: (chooser(t[1]), -t[0]))
        self._vidx = i
        return d
