"""Arcadia: the replicated PMEM log (§4).

Single-primary, multi-backup, single multi-threaded writer.  The write
path is split into four stages (Table 2) so that only the stages that
*must* serialize do:

  reserve   — serialized: allocates ring space and the monotonic LSN.
  copy      — concurrent: writes payload bytes (direct PMEM pointer in
              fast mode, non-temporal-store cost model).
  complete  — concurrent: computes the payload CRC, publishes the record
              header (valid flag), advances the contiguous-complete
              watermark.
  force     — pipelined (DESIGN.md §8): waits for all records up to the
              target LSN to be complete, then *issues* a durability round
              (doorbell post + overlapped local flush) for the un-issued
              byte range.  Up to LogConfig.pipeline_depth rounds may be
              in flight; rounds retire strictly in LSN order, so the
              durable watermark advances over a gapless prefix only (no
              holes in the committed prefix).

Layout (Fig. 3, + the PR-9 lifecycle slot):

  [ superline: AtomicRegion{epoch, head_lsn, start_lsn, head_off} ]
  [ trim watermark: one 8-byte self-validating word               ]
  [ ring: circular buffer of records                              ]

  record := | lsn u64 | size u32 | crc u32 | flags u64 | payload.. pad8 |

Integrity of records follows the integrity primitive with the paper's
optimization: the header is validated by its LSN (recovery knows the
expected LSN of every slot it scans) instead of a second checksum; the
payload is validated by CRC32.  The superline uses the atomicity
primitive with the volatile-index optimization (valid copy = the one
with the newest (epoch, head_lsn, start_lsn)).

Deviation noted (DESIGN.md §2.3): the paper's recovery iterator stops at
the first invalid record; taken literally this would truncate the log at
a mid-log `cleanup`.  We write a CLEANED tombstone flag (CRC preserved)
so the scan can step over reclaimed records — same guarantees, no
truncation.
"""

from __future__ import annotations

import math
import struct
import threading
import time
import zlib
from bisect import bisect_left
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..kernels.checksum.ops import tensor_checksum_batch
from ..device import resolve_device
from .pmem import PMEMDevice
from .primitives import (AtomicRegion, ForceRound, REP_LF, reissue_segs,
                         write_and_force, write_and_force_segs_async)
from .timeline import VirtualTimeline
from .transport import (QuorumError, ReplicationGroup, RoundSalvage,
                        TransportError)

crc32 = zlib.crc32

# ---------------------------------------------------------------------- #
# on-media structures
# ---------------------------------------------------------------------- #
_REC_HDR = struct.Struct("<QIIQ")     # lsn, size, crc, flags
REC_HDR_SIZE = _REC_HDR.size          # 24

FLAG_VALID = 1 << 0
FLAG_PAD = 1 << 1
FLAG_CLEANED = 1 << 2
FLAG_PHASH = 1 << 3   # integrity field is the lane-polynomial hash, not CRC32

# First LSN the vectorized recovery planner may resolve by value: every
# on-media flags word is < 16 (4 flag bits), so a flags word can collide
# with an expected chain LSN only below this — those records take the
# sequential prefix walk instead.  Must be > any FLAG_* combination.
_LSN_VEC_MIN = 16

_SEED = struct.Struct("<QI")          # (lsn, size) checksum seed prefix
_SEED_LANES = _SEED.size // 4         # the seed is 3 uint32 lanes

_SUPER = struct.Struct("<IIQQQQQ")    # magic, version, epoch, head_lsn,
SUPER_MAGIC = 0xA3CAD1A0              # start_lsn, head_off, capacity
SUPER_VERSION = 1
SUPERLINE_SIZE = _SUPER.size          # 44 -> AtomicRegion pads internally


def _align8(n: int) -> int:
    return (n + 7) & ~7


@dataclass
class Superline:
    epoch: int
    head_lsn: int
    start_lsn: int
    head_off: int
    capacity: int

    def pack(self) -> bytes:
        return _SUPER.pack(SUPER_MAGIC, SUPER_VERSION, self.epoch,
                           self.head_lsn, self.start_lsn, self.head_off,
                           self.capacity)

    @classmethod
    def unpack(cls, raw: bytes) -> Optional["Superline"]:
        try:
            magic, ver, epoch, head_lsn, start_lsn, head_off, cap = \
                _SUPER.unpack(raw[:_SUPER.size])
        except struct.error:
            return None
        if magic != SUPER_MAGIC or ver != SUPER_VERSION:
            return None
        return cls(epoch, head_lsn, start_lsn, head_off, cap)


def superline_region(dev: PMEMDevice,
                     repl: Optional[ReplicationGroup] = None,
                     ordering: str = REP_LF) -> AtomicRegion:
    return AtomicRegion(dev, 0, SUPERLINE_SIZE, repl=repl, ordering=ordering,
                        volatile_index=True)


# -- durable trim watermark (DESIGN.md §13) ----------------------------- #
#
# One u64 word between the superline region and the ring:
#
#   word = (trim_lsn << 16) | crc16(trim_lsn)
#
# PMEM persists in 8-byte units, so the word is never torn — advancing
# the watermark is ONE 8-byte-atomic store + flush (the MOD
# minimal-ordering argument applied to truncation).  The embedded check
# makes the word self-validating: bit rot (or pre-lifecycle zeroed
# media, whose check is 0 but crc16(0) is not) decodes to None and
# recovery falls back to the full scan instead of trusting it.
TRIM_SLOT_SIZE = 8
_TRIM_WORD = struct.Struct("<Q")
_TRIM_LSN_MAX = (1 << 48) - 1


def trim_slot_offset() -> int:
    r = AtomicRegion(PMEMDevice(4096), 0, SUPERLINE_SIZE,
                     volatile_index=True).total_size()
    return _align8(r)


def ring_offset() -> int:
    # guard word, then cache-line align (the pre-slot layout started the
    # ring at 128): record line phase is load-bearing for the pinned
    # DeviceStats/LLC contracts — a misphased ring makes concurrent
    # pipelined rounds share cache lines between one round's flush and
    # the next round's DMA snoop, turning the modelled LLC counters
    # scheduling-dependent
    return (trim_slot_offset() + TRIM_SLOT_SIZE + 8 + 63) & ~63


def _trim_check(lsn: int) -> int:
    return crc32(_TRIM_WORD.pack(lsn)) & 0xFFFF


def _trim_encode(lsn: int) -> bytes:
    if not 0 <= lsn <= _TRIM_LSN_MAX:
        raise ValueError(f"trim lsn {lsn} exceeds the 48-bit slot encoding")
    return _TRIM_WORD.pack((lsn << 16) | _trim_check(lsn))


def _trim_decode(raw: bytes) -> Optional[int]:
    (word,) = _TRIM_WORD.unpack(raw)
    lsn = word >> 16
    if (word & 0xFFFF) != _trim_check(lsn):
        return None
    return lsn


def _rec_crc(lsn: int, size: int, payload) -> int:
    """Payload CRC seeded with (lsn, size).

    Plain crc32(payload) has a soundness hole our crash property tests
    found: a torn header on zeroed media yields (size=0, crc=0), and
    crc32(b"") == 0, so a torn record would validate as an empty one.
    Seeding the CRC with the header prefix makes the checksum cover the
    fields the LSN-based header check doesn't.
    """
    return crc32(payload, crc32(_SEED.pack(lsn, size)))


def _lane_buffer(rows: int, lanes: int, device: torch.device) -> torch.Tensor:
    """Zeroed host [rows, lanes] int32 lane matrix, pinned when it is
    bound for the card (one asynchronous copy)."""
    return torch.zeros((rows, lanes), dtype=torch.int32,
                       pin_memory=device.type == "cuda")


def _hash_lane_rows(host: torch.Tensor, device: torch.device) -> np.ndarray:
    """Hash every row of a host lane matrix on ``device``: one copy in,
    one launch and one copy out for the whole matrix (rows of 1 KiB
    records take the short-row kernel, which writes the int64 values
    itself).  Returns uint32 values."""
    mat = host if device.type == "cpu" else host.to(device, non_blocking=True)
    return tensor_checksum_batch(mat).cpu().numpy().astype(np.uint32)


def _seed_lanes(m: np.ndarray, lsns, sizes) -> None:
    """Write the (lsn, size) seed into the first three lanes of each row
    of the uint32 lane view ``m`` (the ``_SEED`` byte layout)."""
    lsns = np.asarray(lsns, dtype=np.uint64)
    m[:, 0] = (lsns & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    m[:, 1] = (lsns >> np.uint64(32)).astype(np.uint32)
    m[:, 2] = np.asarray(sizes, dtype=np.int64) & 0xFFFFFFFF


def _phash_many(items, device: torch.device) -> np.ndarray:
    """FLAG_PHASH integrity values of ``items`` = [(lsn, size, payload)]
    in ONE batched hash: each row is the seed lanes then the payload
    bytes, zero-padded to the longest row (trailing zero lanes add
    nothing, so each value equals the record's own hash)."""
    lanes = _SEED_LANES + (max(len(p) for _, _, p in items) + 3) // 4
    host = _lane_buffer(len(items), lanes, device)
    m = host.numpy().view(np.uint32)
    rows_u8 = m.view(np.uint8)
    for j, (_, _, payload) in enumerate(items):
        rows_u8[j, _SEED.size:_SEED.size + len(payload)] = \
            np.frombuffer(payload, dtype=np.uint8)
    _seed_lanes(m, [it[0] for it in items], [it[1] for it in items])
    return _hash_lane_rows(host, device)


def _rec_phash(lsn: int, size: int, payload, device: torch.device) -> int:
    """Lane-polynomial integrity hash for large payloads (FLAG_PHASH).

    CRC32 is byte-serial; for multi-MB records the batch pipeline routes
    integrity through the blockwise-combinable polynomial hash instead,
    which the CUDA kernel in kernels/checksum evaluates at HBM bandwidth
    on the card (the plain torch version on the CPU — identical value by
    construction).  Seeded with (lsn, size) for the same soundness
    reason as _rec_crc.
    """
    return int(_phash_many([(lsn, size, payload)], device)[0])


def _rec_checksum(lsn: int, size: int, payload, phash: bool,
                  device: torch.device) -> int:
    if phash:
        return _rec_phash(lsn, size, payload, device)
    return _rec_crc(lsn, size, payload)


# record states (volatile tracking)
RESERVED, COMPLETED, FORCED = 0, 1, 2

# After this many failed salvage retries for the same segment, its
# deferred failure stops being held back at force-issue time: a backup
# that never rejoins must not let wait=False forces spin silently
# forever (the PR-4 surface-on-next-force contract, restored after a
# bounded retry budget).
_SALVAGE_RETRY_LIMIT = 3


def _remaining(deadline: Optional[float]) -> Optional[float]:
    if deadline is None:
        return None
    return max(0.0, deadline - time.monotonic())


@dataclass(slots=True)
class _SalvageSeg:
    """One failed round awaiting salvage (DESIGN.md §9).

    Mirrors the failed ``_PipeRound``'s coverage (so the re-issue retires
    to the same watermarks) plus the re-issuable remainder captured from
    its quorum round.  ``deferred`` holds the failure exception(s) that
    were stashed for the next force/drain with no covering waiter: a
    successful salvage clears them — durability was achieved after all —
    while a failed or never-attempted salvage leaves them to surface.
    """

    end_lsn: int
    start_off: int
    end_off: int
    salv: RoundSalvage
    deferred: List[BaseException] = field(default_factory=list)
    attempts: int = 0     # failed salvage retries (bounded: see
                          # _SALVAGE_RETRY_LIMIT)


@dataclass(slots=True)
class _PipeRound:
    """One in-flight durability round of the pipelined force engine.

    ``end_off`` is the raw (un-wrapped) ring-relative end of the round's
    byte range; the durable offset it retires to is ``end_off % cap``.
    ``error`` is set when the round (or an earlier one — in-order commit
    cannot skip a hole) failed; ``waiters`` counts threads blocked on
    this round so a failure with no waiter is deferred to the next
    force/drain instead of being dropped.  A salvage round (one that
    re-issues previously failed rounds) carries the stash entries it
    covers in ``salvage_src`` — retired, it clears their deferred
    errors; failed, it re-stashes them with updated ack sets.
    """

    end_lsn: int
    start_off: int
    end_off: int
    handle: Optional[ForceRound] = None
    error: Optional[BaseException] = None
    waiters: int = 0
    salvage_src: Optional[List[_SalvageSeg]] = None
    gen: int = 0          # salvage generation at issue (tombstone guard)
    issued_at: float = 0.0  # monotonic issue stamp (ack-rate estimator)
    vt_after: float = 0.0   # virtual-time dependency horizon: this round
                            # cannot start before the round that vacated
                            # its pipeline slot ended (DESIGN.md §14)


@dataclass(slots=True)
class _Rec:
    lsn: int
    off: int            # header offset in device space
    size: int           # payload bytes
    extent: int         # total bytes incl. header + pad
    state: int = RESERVED
    pad: bool = False


@dataclass
class _ScanPlan:
    """Output of one recovery-chain planning pass (either planner).

    ``recs`` holds one (ring_pos, size, crc, flags, extent, used_at_entry)
    tuple per admitted record, in chain order; ``tail``/``used``/
    ``next_lsn`` are the walk-exit state assuming every admitted record
    also passes payload validation (the batched checksum pass may still
    truncate the plan at an earlier ordinal).
    """

    recs: List[Tuple[int, int, int, int, int, int]]
    tail: int
    used: int
    next_lsn: int


def _first_bad_payload(raw: torch.Tensor, items,
                       device: torch.device) -> Optional[int]:
    """Batched payload-integrity validation over one ring snapshot.

    ``raw`` is the snapshot as a CPU uint8 tensor.  ``items``: (ordinal,
    ring_pos, lsn, size, crc, flags) per record whose payload needs
    checking, ascending by ordinal.  CRC32 records go through one
    C-dispatch pass over zero-copy snapshot slices (early exit at the
    first failure); FLAG_PHASH records are evaluated in ONE batched
    lane-polynomial hash through kernels/checksum — the lane matrix goes
    to ``device`` in one copy and is hashed in one launch.  Returns the
    smallest failing ordinal, or None if everything checks out.
    """
    bad: Optional[int] = None
    snap = raw.numpy()
    mv = memoryview(snap)
    pack = _SEED.pack
    _crc = crc32
    ph_items = []
    for it in items:
        if it[5] & FLAG_PHASH:
            ph_items.append(it)
            continue
        if bad is not None:
            continue   # past the first CRC failure; only phash order left
        i, pos, lsn, size, crc, _ = it
        p0 = pos + REC_HDR_SIZE
        if _crc(mv[p0:p0 + size], _crc(pack(lsn, size))) != crc:
            bad = i
    if bad is not None:
        # a CRC failure already truncates the chain there; only phash
        # records BEFORE it could move the truncation point earlier
        ph_items = [it for it in ph_items if it[0] < bad]
    if ph_items:
        fails = np.flatnonzero(_phash_mismatch(
            snap, [it[1] for it in ph_items], [it[2] for it in ph_items],
            [it[3] for it in ph_items], [it[4] for it in ph_items], device))
        if fails.size:
            b = ph_items[int(fails[0])][0]
            bad = b if bad is None else min(bad, b)
    return bad


def _phash_mismatch(snap: np.ndarray, pos, lsns, sizes, crcs,
                    device: torch.device) -> np.ndarray:
    """One bool per FLAG_PHASH record: does the hash of its payload differ
    from its header's?  ``snap`` is the uint8 image the records lie in,
    ``pos`` each header's offset in it, ``lsns``/``sizes``/``crcs`` the
    header fields.  All rows go to ``device`` in one lane matrix (one
    copy) and are hashed in one launch."""
    cap = snap.size
    pos = np.asarray(pos, dtype=np.int64)
    claimed = np.asarray(sizes, dtype=np.int64)
    sizes = np.minimum(claimed, np.maximum(cap - pos - REC_HDR_SIZE, 0))
    starts = pos + REC_HDR_SIZE
    lanes = _SEED_LANES + (int(sizes.max()) + 3) // 4
    host = _lane_buffer(pos.size, lanes, device)
    mat = host.numpy().view(np.uint32)
    rows_u8 = mat.view(np.uint8)
    # gather the payload rows of each distinct length in one strided
    # fancy-index (a window view of the snapshot per length)
    for n in np.unique(sizes).tolist():
        if n == 0:
            continue
        sel = np.flatnonzero(sizes == n)
        windows = np.lib.stride_tricks.sliding_window_view(snap, n)
        rows_u8[sel, _SEED.size:_SEED.size + n] = windows[starts[sel]]
    # hash covers the *claimed* size (clamped rows fail the compare)
    _seed_lanes(mat, lsns, claimed)
    vals = _hash_lane_rows(host, device)
    return vals != (np.asarray(crcs, dtype=np.int64)
                    & 0xFFFFFFFF).astype(np.uint32)


def _first_true(mask: torch.Tensor, default: int) -> int:
    """Index of the first True in a 1-D bool tensor, else ``default``."""
    hits = torch.nonzero(mask)
    return int(hits[0]) if hits.numel() else default


class AckRateEstimator:
    """Ack-rate (bandwidth-delay) grow signal for the adaptive depth
    controller (DESIGN.md §9-10).

    Two EMAs: round latency L (issue → retire) and leader arrival gap
    G — arrivals are stamped BEFORE any pipeline-slot wait, so a
    congested pipeline cannot masquerade demand as service time.
    ``ceil(L / G)`` is the bandwidth-delay product in rounds: how many
    rounds the wire absorbs at the offered leader rate.  The controller
    grows only while that product is at least the current depth — a
    saturated pipeline issues one round per L/depth so its BDP *equals*
    its depth (grow), while a service-matched closed loop (one blocking
    producer, G ≈ L) reports BDP 1 and adding slots is vetoed.  The
    pre-PR6 signal ("grow whenever a leader finds the pipeline full")
    grew in both cases; it survives only as the bootstrap before the
    first retirement has been observed.
    """

    __slots__ = ("alpha", "lat_ema", "gap_ema", "last_arrival")

    def __init__(self, alpha: float = 0.5):
        self.alpha = float(alpha)
        self.lat_ema: Optional[float] = None   # round latency (s)
        self.gap_ema: Optional[float] = None   # leader arrival gap (s)
        self.last_arrival: Optional[float] = None

    def _mix(self, ema: Optional[float], x: float) -> float:
        return x if ema is None else self.alpha * x + (1 - self.alpha) * ema

    def observe_arrival(self, now: float) -> None:
        """A force leader wants to issue (stamped pre-slot-wait)."""
        if self.last_arrival is not None:
            self.gap_ema = self._mix(self.gap_ema,
                                     max(now - self.last_arrival, 0.0))
        self.last_arrival = now

    def observe_retire(self, now: float, issued_at: float) -> None:
        """A round retired ``now`` that was issued at ``issued_at``."""
        self.lat_ema = self._mix(self.lat_ema, max(now - issued_at, 0.0))

    def bdp_rounds(self) -> Optional[int]:
        """Estimated bandwidth-delay product in rounds (None until both
        a retirement and an arrival gap have been observed)."""
        if self.lat_ema is None or self.gap_ema is None:
            return None
        return max(1, math.ceil(self.lat_ema / max(self.gap_ema, 1e-9)))

    def supports_growth(self, depth: int) -> bool:
        bdp = self.bdp_rounds()
        return True if bdp is None else bdp >= depth


class LogError(Exception):
    pass


class LogFullError(LogError):
    pass


class CorruptLogError(LogError):
    pass


class TrimError(LogError):
    """Bulk truncation asked to drop records the crash story cannot
    cover (beyond the durable watermark — nothing un-acked may be
    declared checkpointed)."""


@dataclass
class LogConfig:
    capacity: int = 1 << 20          # ring bytes (excl. superline)
    write_quorum: int = 1
    ordering: str = REP_LF
    local_durable: bool = True       # False => remote-only mode
    max_threads: int = 64            # T in the F x T bound
    # payloads >= this many bytes are integrity-hashed with the blockwise
    # polynomial hash (the CUDA kernel on the card) instead of CRC32;
    # None = never
    phash_threshold: Optional[int] = 1 << 20
    # max in-flight durability rounds (DESIGN.md §8): 1 = the serial force
    # of the paper's Table 2, >= 2 overlaps wire time across rounds while
    # the durable watermark still retires strictly in LSN order
    pipeline_depth: int = 1
    # adaptive depth controller (DESIGN.md §9): pipeline_depth becomes a
    # CEILING; the effective depth starts at 1, grows while posts outpace
    # retirements, halves on a round failure or slot timeout, and re-grows
    # only after a clean window of retirements
    adaptive_depth: bool = False
    # partial-quorum salvage (DESIGN.md §9): a failed round's already
    # acked (backup × range) deltas are kept and the next force leader
    # re-issues only what never acked; False = the PR-4 behavior (the
    # whole failed range is re-issued from scratch)
    salvage: bool = True
    # cap on the wire-image bytes the salvage stash may pin during a
    # long outage; the OLDEST segments' staged images spill first (their
    # re-issue re-snapshots the ranges from the primary device instead).
    # None = unbounded.  Spills are counted in Log.stats().
    salvage_stash_cap: Optional[int] = None
    # lifecycle backpressure (DESIGN.md §13): when the ring's free
    # fraction drops to or below this after a reservation, the
    # registered ``Log.on_free_space_low`` callback fires once per
    # crossing (re-armed when trim raises free space back above it).
    # The same callback is also tried once, last-ditch, when a reserve
    # hits LogFullError — checkpoint+trim instead of failing the wave.
    # None disables the threshold (the LogFullError retry still runs
    # whenever a callback is registered).
    free_space_low_frac: Optional[float] = None


@dataclass
class _BatchSeg:
    """One contiguous ring extent of a batch, staged in DRAM.

    The whole segment (headers + payloads + pad headers) hits the device
    as a single ``write`` at complete time — one bookkeeping operation
    for N records instead of 3N.
    """

    ring_off: int
    buf: bytearray


@dataclass
class Batch:
    """A reserve_batch() reservation: N records allocated under one lock.

    ``lsns`` lists the payload records only (pads are internal).  Payload
    bytes are assembled in the staged segment buffers via ``view()`` or
    ``Log.copy_batch``; ``Log.complete_batch`` checksums everything in
    one sweep and publishes the segments.
    """

    lsns: List[int]
    sizes: List[int]
    _items: List[Tuple["_Rec", int, int]] = field(repr=False, default_factory=list)
    _segs: List[_BatchSeg] = field(repr=False, default_factory=list)
    _pad_lsns: List[int] = field(repr=False, default_factory=list)
    _completed: bool = False

    def view(self, i: int) -> memoryview:
        """Writable staging pointer for payload ``i`` (the batch analogue
        of the direct PMEM pointer reserve() returns)."""
        rec, seg_idx, pay_off = self._items[i]
        return memoryview(self._segs[seg_idx].buf)[pay_off : pay_off + rec.size]


class Log:
    """The Arcadia log over one local device + optional replication group."""

    def __init__(self, dev: PMEMDevice, cfg: LogConfig,
                 repl: Optional[ReplicationGroup] = None,
                 device="cuda"):
        self.dev = dev
        self.cfg = cfg
        self.repl = repl
        # where integrity hashing runs; the PMEM images stay in host memory
        self.device = resolve_device(device)
        self.ring_off = ring_offset()
        if cfg.capacity % 8 != 0 or cfg.capacity < 64:
            raise ValueError("ring capacity must be 8-byte aligned and >= 64")
        if cfg.capacity + self.ring_off > dev.size:
            raise ValueError("device too small for configured capacity")
        if cfg.pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        self._super = superline_region(dev, repl, cfg.ordering)

        self._alloc_lock = threading.Lock()
        self._commit_cv = threading.Condition()

        # volatile write-path state (rebuilt by recovery)
        self._recs: Dict[int, _Rec] = {}
        self._next_lsn = 1
        self._tail_off = 0            # ring-relative next alloc offset
        self._used = 0                # live bytes in ring
        self._complete_upto = 0       # all lsn <= this are COMPLETED
        self._durable_lsn = 0         # all lsn <= this are durable (in order)
        self._durable_off = 0         # ring-relative first un-retired byte
        # pipelined force engine (DESIGN.md §8): doorbell posts are
        # serialized under _issue_lock so rounds hit every FIFO lane in
        # LSN order; _inflight holds issued-not-yet-retired rounds and
        # retirement advances the durable watermark head-first only.
        self._issue_lock = threading.Lock()
        self._inflight: Deque[_PipeRound] = deque()
        self._issue_lsn = 0           # all lsn <= this are covered by a round
        self._issue_off = 0           # ring-relative first un-issued byte
        self._pipe_errors: List[BaseException] = []
        # partial-quorum salvage stash (DESIGN.md §9): failed rounds in
        # LSN order, each carrying the (backup × range) deltas that never
        # acked; the next force leader re-issues exactly those
        self._salvage: List[_SalvageSeg] = []
        self._salvage_gen = 0         # bumped whenever a tombstone rewrite
                                      # invalidates pre-tombstone wire images
        self.salvage_rounds_total = 0     # salvage rounds issued
        self.reissue_bytes_total = 0      # wire bytes actually re-sent
        self.full_reissue_bytes_total = 0  # counterfactual: full re-issue
        self.salvage_spilled_bytes = 0    # stash-cap spills (wire-image
        self.salvage_spilled_images = 0   # bytes / lane images dropped)
        # adaptive depth controller (DESIGN.md §9): cfg.pipeline_depth is
        # the ceiling; _depth is the effective in-flight limit
        self._depth = 1 if cfg.adaptive_depth else cfg.pipeline_depth
        self._clean_retires = 0       # retirements since the last failure
        self._grow_after = 0          # clean window required before re-grow
        self._issue_seq = 0           # rounds issued (trajectory x-axis)
        self.depth_trajectory: List[Tuple[int, int]] = [(0, self._depth)]
        self.depth_trajectory_dropped = 0   # transitions beyond the cap
        # ack-rate (bandwidth-delay) grow signal for the controller
        self._ack_est = AckRateEstimator()
        # per-round durable-ack timestamps: one (end_lsn, wall) entry per
        # retirement, contiguous over the durable prefix, so
        # durable_ack_time() resolves any LSN to the moment its covering
        # round retired — record-level latency truth for batched appends
        # and the ingestion front end (DESIGN.md §10)
        self._ack_ends: List[int] = []
        self._ack_wall: List[float] = []
        self._ack_base = 0            # LSNs <= this have no recorded time
        self._ack_base_wall: Optional[float] = None  # boundary retire stamp
        self._epoch = 1
        self._head_lsn = 1
        self._head_off = 0
        self._start_lsn = 1
        # lifecycle (DESIGN.md §13): durable trim watermark + free-space
        # backpressure.  The callback fires OUTSIDE every log lock and
        # only at complete()/complete_batch() — when the record that
        # crossed the threshold is already committed, so a sync
        # checkpoint save inside the callback cannot deadlock on the
        # in-order-commit hole its own reservation would leave.
        self.trim_off = trim_slot_offset()
        self._trim_lsn = 0            # last bulk-trimmed LSN (volatile view)
        self.on_free_space_low = None  # Callable[[Log], None] | None
        self._space_low_fired = False
        self._space_low_pending = False   # crossing seen, fire at complete
        self._space_low_guard = threading.Lock()
        self.space_low_triggers = 0   # threshold crossings fired
        self.full_reclaims = 0        # LogFullError last-ditch reclaims
        self.trimmed_records_total = 0
        self.trimmed_bytes_total = 0
        self.force_vns_total = 0.0    # accumulated modelled hardware WORK
        # virtual-timeline modelled TIME (DESIGN.md §14): retired rounds
        # are placed on per-resource clocks (cpu / flush / wire:<id>),
        # so overlapped pipeline rounds overlap in modelled time instead
        # of being charged as a serial sum.  force_vns_total stays the
        # work integral (fig8's per-record cost basis); _durable_vtime
        # is the monotone end of the latest retired round.
        self.timeline = VirtualTimeline()
        self._durable_vtime = 0.0
        # ends of recently retired rounds, retirement order: round i's
        # dependency horizon is the end of round i-depth (the round
        # whose retirement vacated the slot i was issued into)
        self._vt_tail: Deque[float] = deque(maxlen=cfg.pipeline_depth + 2)
        # per-round modelled charge history, parallel to _ack_ends, so
        # timed appends attribute to a waiter exactly the rounds that
        # covered it (not whatever else retired concurrently)
        self._ack_vns: List[float] = []
        self._ack_vtime: List[float] = []
        self._ack_base_vns = 0.0      # boundary round's charge (aged-out)

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    @classmethod
    def create(cls, dev: PMEMDevice, cfg: LogConfig,
               repl: Optional[ReplicationGroup] = None,
               device="cuda") -> "Log":
        log = cls(dev, cfg, repl, device=device)
        # seed the trim slot with a valid zero watermark so recovery can
        # tell "no trim yet" from torn/alien media (zeroed bytes fail
        # the embedded check and are ignored)
        dev.write(log.trim_off, _trim_encode(0))
        write_and_force(dev, log.trim_off, TRIM_SLOT_SIZE, repl,
                        cfg.ordering, local_durable=cfg.local_durable)
        log._write_superline()
        return log

    @classmethod
    def open(cls, dev: PMEMDevice, cfg: LogConfig,
             repl: Optional[ReplicationGroup] = None,
             device="cuda") -> "Log":
        """Local (single-copy) recovery: §4.3 Recovery Iterator."""
        log = cls(dev, cfg, repl, device=device)
        log._recover_local()
        return log

    def _write_superline(self) -> float:
        s = Superline(self._epoch, self._head_lsn, self._start_lsn,
                      self._head_off, self.cfg.capacity)
        return self._super.atomic_write(s.pack().ljust(SUPERLINE_SIZE, b"\0"))

    @staticmethod
    def _superline_score(raw: bytes) -> tuple:
        s = Superline.unpack(raw)
        if s is None:
            return (-1, -1, -1)
        return (s.epoch, s.head_lsn, s.start_lsn)

    def read_superline(self) -> Optional[Superline]:
        raw = self._super.recover(chooser=lambda d: self._superline_score(d))
        return Superline.unpack(raw) if raw is not None else None

    # ------------------------------------------------------------------ #
    # write path
    # ------------------------------------------------------------------ #
    def _abs(self, ring_rel: int) -> int:
        return self.ring_off + ring_rel

    def _fit(self, size: int) -> Tuple[int, Optional[int]]:
        """Find space for header+payload at the tail; returns
        (record_ring_off, pad_extent | None if no pad record needed)."""
        extent = _align8(REC_HDR_SIZE + size)
        room = self.cfg.capacity - self._tail_off
        if extent <= room:
            return self._tail_off, None
        # need to wrap: burn the remainder with a PAD record (or implicit
        # skip when not even a header fits — scan applies the same rule)
        return 0, room

    def reserve(self, size: int) -> Tuple[int, Optional[memoryview]]:
        """Serialized: allocate space + LSN.  Returns (id, direct pointer).

        The id *is* the LSN (getLSN is the identity map — kept in the API
        for fidelity with Table 2).  The pointer is None in strict device
        mode; use copy() then.
        """
        if size < 0 or _align8(REC_HDR_SIZE + size) > self.cfg.capacity:
            raise ValueError("bad record size")
        try:
            with self._alloc_lock:
                lsn, rec, fire = self._reserve_locked(size)
        except LogFullError:
            # graceful degradation (DESIGN.md §13): give the lifecycle
            # callback one shot at checkpoint+trim, then retry once
            if not self._reclaim_on_full():
                raise
            with self._alloc_lock:
                lsn, rec, fire = self._reserve_locked(size)
        if fire:
            # defer to complete(): firing here would run the callback
            # while THIS record is reserved-but-uncompleted, and a sync
            # checkpoint save inside it would wait forever on in-order
            # commit past the hole
            self._space_low_pending = True
        return lsn, self.dev.view(rec.off + REC_HDR_SIZE, size)

    def _reserve_locked(self, size: int) -> Tuple[int, "_Rec", bool]:
        off, pad_room = self._fit(size)
        extent = _align8(REC_HDR_SIZE + size)
        need = extent + (pad_room or 0)
        if self._used + need > self.cfg.capacity:
            raise LogFullError(
                f"log full: used={self._used} need={need} "
                f"cap={self.cfg.capacity}")
        if pad_room is not None and pad_room >= REC_HDR_SIZE:
            pad_lsn = self._next_lsn
            self._next_lsn += 1
            self._write_header(pad_room_off := self._tail_off, pad_lsn,
                               pad_room - REC_HDR_SIZE, 0,
                               FLAG_VALID | FLAG_PAD)
            pr = _Rec(pad_lsn, self._abs(pad_room_off),
                      pad_room - REC_HDR_SIZE, pad_room, state=COMPLETED,
                      pad=True)
            self._recs[pad_lsn] = pr
            self._mark_complete(pad_lsn)
        lsn = self._next_lsn
        self._next_lsn += 1
        rec = _Rec(lsn, self._abs(off), size, extent)
        self._recs[lsn] = rec
        self._tail_off = off + extent
        self._used += need
        # No header is published here: complete() writes the full
        # header (lsn, size, crc, flags) in one device write.  The
        # provisional flags=0 header the pre-PR4 path wrote was
        # crash-equivalent to stale ring bytes — it was itself
        # unflushed, so a crash could drop it and recovery already
        # rejects whatever lies there (LSN mismatch, or the seeded
        # payload checksum) — and complete() rewrote every field.
        return lsn, rec, self._space_low_check_locked()

    # -- lifecycle backpressure (DESIGN.md §13) ------------------------- #
    def _space_low_check_locked(self) -> bool:
        """Latch the once-per-crossing threshold signal; caller fires
        the callback after releasing the allocation lock."""
        f = self.cfg.free_space_low_frac
        if f is None or self.on_free_space_low is None \
                or self._space_low_fired:
            return False
        if self.cfg.capacity - self._used <= f * self.cfg.capacity:
            self._space_low_fired = True
            return True
        return False

    def _rearm_space_low_locked(self) -> None:
        f = self.cfg.free_space_low_frac
        if f is not None and \
                self.cfg.capacity - self._used > f * self.cfg.capacity:
            self._space_low_fired = False

    def _fire_space_low(self) -> bool:
        """Run the reclaim callback outside every log lock.  The guard
        is non-blocking and non-reentrant on purpose: the callback's own
        appends (checkpoint manifest) re-enter reserve, and a nested
        crossing must not stack a second reclaim on the first."""
        cb = self.on_free_space_low
        if cb is None or not self._space_low_guard.acquire(blocking=False):
            return False
        try:
            self.space_low_triggers += 1
            cb(self)
            return True
        finally:
            self._space_low_guard.release()

    def _reclaim_on_full(self) -> bool:
        """Last-ditch reclaim when a reservation hits LogFullError:
        True when a callback actually ran (caller retries once)."""
        cb = self.on_free_space_low
        if cb is None or not self._space_low_guard.acquire(blocking=False):
            return False
        try:
            self.full_reclaims += 1
            cb(self)
            return True
        finally:
            self._space_low_guard.release()

    @property
    def free_bytes(self) -> int:
        with self._alloc_lock:
            return self.cfg.capacity - self._used

    @property
    def trim_lsn(self) -> int:
        """Last LSN reclaimed by bulk truncation (the durable trim
        watermark's volatile view)."""
        with self._commit_cv:
            return self._trim_lsn

    def _write_header(self, ring_off: int, lsn: int, size: int, crc: int,
                      flags: int) -> float:
        return self.dev.write(self._abs(ring_off),
                              _REC_HDR.pack(lsn, size, crc, flags))

    def getLSN(self, rec_id: int) -> int:
        return rec_id

    def copy(self, rec_id: int, data: bytes, at: int = 0) -> float:
        """Concurrent: copy payload bytes into the reserved record
        (non-temporal-store path)."""
        rec = self._recs[rec_id]
        if at + len(data) > rec.size:
            raise ValueError("copy out of record bounds")
        return self.dev.write(rec.off + REC_HDR_SIZE + at, data)

    def _use_phash(self, size: int) -> bool:
        t = self.cfg.phash_threshold
        return t is not None and size >= t

    def complete(self, rec_id: int) -> float:
        """Concurrent: checksum the payload and publish the valid header."""
        rec = self._recs[rec_id]
        view = self.dev.view(rec.off + REC_HDR_SIZE, rec.size)
        payload = view if view is not None else self.dev.read(
            rec.off + REC_HDR_SIZE, rec.size)
        phash = self._use_phash(rec.size)
        crc = _rec_checksum(rec.lsn, rec.size, payload, phash, self.device)
        flags = FLAG_VALID | (FLAG_PHASH if phash else 0)
        vns = self.dev.write(
            rec.off, _REC_HDR.pack(rec.lsn, rec.size, crc, flags))
        vns += self.dev.cost.crc_byte_ns * rec.size
        self._mark_complete(rec_id)
        if self._space_low_pending:
            # the crossing record is committed now, so a sync
            # checkpoint inside the callback can force its manifest
            # without waiting on a reservation hole (benign race on
            # the flag: the guard is non-reentrant and the latch
            # stops refires)
            self._space_low_pending = False
            self._fire_space_low()
        return vns

    def _mark_complete(self, rec_id: int) -> None:
        with self._commit_cv:
            self._recs[rec_id].state = COMPLETED
            while True:
                nxt = self._recs.get(self._complete_upto + 1)
                if nxt is None or nxt.state < COMPLETED:
                    break
                self._complete_upto += 1
            self._commit_cv.notify_all()

    def _mark_complete_many(self, lsns: List[int]) -> None:
        """One _commit_cv pass for a whole batch (vs one per record)."""
        if not lsns:
            return
        with self._commit_cv:
            recs = self._recs
            for lsn in lsns:
                rec = recs[lsn]
                if rec.state < COMPLETED:
                    rec.state = COMPLETED
            upto = self._complete_upto
            while True:
                nxt = recs.get(upto + 1)
                if nxt is None or nxt.state < COMPLETED:
                    break
                upto += 1
            self._complete_upto = upto
            self._commit_cv.notify_all()

    # -- force: the pipelined force engine (DESIGN.md §8-9) --------------- #
    @property
    def _force_busy(self) -> bool:
        """True when no further round can be issued right now (pipeline
        full).  Kept for introspection; the pre-PR4 serial engine exposed
        the same flag for its single critical section."""
        return len(self._inflight) >= self._depth

    @property
    def pipeline_depth(self) -> int:
        """The effective in-flight round limit right now: the adaptive
        controller's current depth, or cfg.pipeline_depth when static."""
        with self._commit_cv:
            return self._depth

    @property
    def pipeline_free(self) -> bool:
        """True when the force engine could issue another round right
        now (pipeline not full at the controller's current depth) — the
        ingestion collector's slot-free flush trigger (DESIGN.md §10)."""
        with self._commit_cv:
            return len(self._inflight) < self._depth

    def capture_watermarks(self) -> Tuple[int, int]:
        """(issue_lsn, durable_lsn) in one commit-lock pass.  The shard
        router's two-phase snapshot cut (DESIGN.md §12) calls this while
        holding ``_issue_lock``, so the issue watermark it records
        cannot advance until the cut releases the lock — every record a
        force had issued before the freeze is inside the cut, everything
        later is outside it."""
        with self._commit_cv:
            return self._issue_lsn, self._durable_lsn

    def wait_durable_change(self, last_seen: int,
                            timeout: Optional[float] = None) -> int:
        """Block until the durable watermark differs from ``last_seen``
        (or timeout); returns the current watermark.  The ingestion
        front end's acker thread parks here instead of polling."""
        with self._commit_cv:
            self._commit_cv.wait_for(
                lambda: self._durable_lsn != last_seen, timeout=timeout)
            return self._durable_lsn

    # bound on the per-round ack-timestamp history.  When entries age
    # out, the boundary's wall stamp is KEPT: retirements are
    # wall-monotone, so any LSN at or below the trimmed horizon retired
    # no later than the boundary did, and a lookup there returns that
    # stamp (a tight upper bound) instead of None — callers used to fall
    # back to "now", which silently inflated latency accounting once
    # bulk trim made deep head movement routine (PR 9 satellite).
    _ACK_LOG_CAP = 1 << 15

    def _record_ack_locked(self, end_lsn: int, now: float,
                           vns: float = 0.0, vtime: float = 0.0) -> None:
        self._ack_ends.append(end_lsn)
        self._ack_wall.append(now)
        self._ack_vns.append(vns)
        self._ack_vtime.append(vtime)
        if len(self._ack_ends) > self._ACK_LOG_CAP:
            drop = self._ACK_LOG_CAP // 2
            self._ack_base = self._ack_ends[drop - 1]
            self._ack_base_wall = self._ack_wall[drop - 1]
            self._ack_base_vns = self._ack_vns[drop - 1]
            del self._ack_ends[:drop]
            del self._ack_wall[:drop]
            del self._ack_vns[:drop]
            del self._ack_vtime[:drop]

    def durable_ack_time(self, lsn: int) -> Optional[float]:
        """The wall moment (time.monotonic domain) the round covering
        ``lsn`` retired — i.e. when a producer of that record could
        first have been acked durable.  For an LSN that aged out of the
        bounded history, the history boundary's stamp (an upper bound on
        the true retire moment).  None if the LSN is not durable yet or
        predates this process."""
        with self._commit_cv:
            return self._ack_time_locked(lsn)

    def _ack_time_locked(self, lsn: int) -> Optional[float]:
        if lsn > self._durable_lsn:
            return None
        if lsn <= self._ack_base:
            # aged out (or recovered): the boundary stamp bounds the
            # true retire moment from above; None only when the record
            # predates this process entirely
            return self._ack_base_wall
        i = bisect_left(self._ack_ends, lsn)
        if i == len(self._ack_ends):
            return None
        return self._ack_wall[i]

    def durable_ack_times(self, lsns: List[int]) -> List[Optional[float]]:
        """Bulk durable_ack_time: one lock acquisition for a whole wave
        (the ingestion acker stamps every ticket of a retired round in
        one pass)."""
        with self._commit_cv:
            return [self._ack_time_locked(l) for l in lsns]

    def _round_index_locked(self, lsn: int) -> Optional[int]:
        """Index into the ack history of the round that covered ``lsn``
        (-1 for an LSN that aged out of the bounded history; None if not
        durable yet or predating this process)."""
        if lsn > self._durable_lsn:
            return None
        if lsn <= self._ack_base:
            return -1
        i = bisect_left(self._ack_ends, lsn)
        if i == len(self._ack_ends):
            return None
        return i

    def durable_round_vns(self, lsn: int) -> Optional[float]:
        """Modelled work (vns) of the ONE durability round that covered
        ``lsn`` — the per-waiter attribution timed appends use instead
        of a ``force_vns_total`` delta, which raced with every
        concurrent leader's and salvage retry's charge.  For an LSN that
        aged out of the bounded history, the boundary round's charge (an
        arbitrary but harmless stand-in: timed appends read this within
        a round-trip of their own force).  None if not durable yet."""
        with self._commit_cv:
            i = self._round_index_locked(lsn)
            if i is None:
                return None
            return self._ack_base_vns if i < 0 else self._ack_vns[i]

    def durable_rounds_vns(self, lsns: List[int]) -> float:
        """Summed modelled work of the DISTINCT rounds covering ``lsns``
        (a batch whose members rode one round is charged that round
        once).  Not-yet-durable members contribute nothing."""
        with self._commit_cv:
            seen = set()
            total = 0.0
            for lsn in lsns:
                i = self._round_index_locked(lsn)
                if i is None or i in seen:
                    continue
                seen.add(i)
                total += self._ack_base_vns if i < 0 else self._ack_vns[i]
            return total

    # a flapping backup can oscillate the controller indefinitely; the
    # trajectory is an observability aid, not a ledger — cap it
    _DEPTH_TRAJECTORY_CAP = 4096

    def _record_depth_locked(self) -> None:
        if len(self.depth_trajectory) >= self._DEPTH_TRAJECTORY_CAP:
            self.depth_trajectory_dropped += 1
            return
        self.depth_trajectory.append((self._issue_seq, self._depth))

    def _maybe_grow_locked(self) -> None:
        """Grow the effective depth when a leader arrives while the
        pipeline is full AND the ack-rate estimator's bandwidth-delay
        product says another slot would actually be absorbed (PR 6 —
        fullness alone used to suffice, which also grew service-matched
        closed loops that gain nothing from extra slots).  Growth is
        gated, after a failure, on a clean window of retirements
        (DESIGN.md §9)."""
        if (self.cfg.adaptive_depth
                and len(self._inflight) >= self._depth
                and self._depth < self.cfg.pipeline_depth
                and self._clean_retires >= self._grow_after
                and self._ack_est.supports_growth(self._depth)):
            self._depth += 1
            self._record_depth_locked()

    def _shrink_locked(self) -> None:
        """Halve the effective depth (round failure or slot timeout) and
        require a clean window of retirements before re-growing."""
        if not self.cfg.adaptive_depth or self._depth <= 1:
            return
        self._depth = max(1, self._depth // 2)
        self._clean_retires = 0
        self._grow_after = self._depth
        self._record_depth_locked()

    def force(self, rec_id: int, freq: int = 1,
              timeout: Optional[float] = None, wait: bool = True) -> int:
        """Make records durable in order.

        With ``freq`` F > 1, only a call whose LSN ≡ 0 (mod F) forces; it
        becomes the *force leader* for every unforced record up to its own
        LSN (§4.4).  Other calls return immediately (their durability is
        covered by a later leader — bounded by the F×T window).

        A leader *issues* a durability round: it claims the un-issued ring
        range up to its LSN, posts the replication doorbell, and runs the
        local flush overlapped with wire time.  Up to
        ``LogConfig.pipeline_depth`` rounds may be in flight at once;
        rounds retire strictly in LSN order, so ``durable_lsn`` only ever
        advances over a gapless prefix.  With ``wait=False`` the leader
        returns right after issuing (non-blocking handoff): the round
        retires in the background when its quorum fills, and a failure
        with no covering waiter surfaces on the next force or ``drain``.

        Returns the durable LSN watermark at return time.  Raises
        QuorumError if replication cannot meet W (a quorum failure in
        round N also fails every issued round > N — the hole can never be
        skipped — and propagates to every waiter those rounds cover).
        """
        lsn = rec_id
        if freq > 1 and lsn % freq != 0:
            with self._commit_cv:
                return self._durable_lsn
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._commit_cv:
            # total order: wait for every earlier record to be complete
            ok = self._commit_cv.wait_for(
                lambda: self._complete_upto >= lsn,
                timeout=_remaining(deadline))
            if not ok:
                raise LogError(f"force({lsn}) timed out waiting for "
                               f"complete_upto={self._complete_upto}")
        entry = self._pipe_issue(lsn, deadline)
        if not wait:
            with self._commit_cv:
                return self._durable_lsn
        return self._pipe_await(lsn, entry, deadline)

    def _range_segs(self, start: int, end: int) -> List[Tuple[int, int]]:
        """Absolute (off, n) scatter list for ring-relative [start, end);
        a wrapped range yields two segments riding ONE doorbell-batched
        replication round."""
        if end == start:
            return []
        if end > start:
            segs = [(start, end - start)]
        else:
            segs = [(start, self.cfg.capacity - start), (0, end)]
        return [(self._abs(off), n) for off, n in segs if n > 0]

    def _covering_round_locked(self, lsn: int) -> Optional[_PipeRound]:
        for e in self._inflight:
            if e.end_lsn >= lsn:
                return e
        return None

    def _pipe_issue(self, lsn: int, deadline: Optional[float]
                    ) -> Optional[_PipeRound]:
        """Become the issue leader for ``lsn`` unless it is already
        covered: claim the un-issued ring range, post the replication
        doorbell and run the overlapped local flush.  Posts are
        serialized under ``_issue_lock`` so rounds reach every FIFO lane
        in LSN order.  A pending salvage stash rides FIRST, bundled with
        the leader's own fresh range into one round — only the (backup ×
        range) deltas that never acked are re-sent, and the fresh bytes
        can never retire ahead of the hole.  Returns the in-flight round
        covering ``lsn`` (None when already durable)."""
        with self._commit_cv:
            # fast path: an already-durable or already-covered LSN must
            # not queue behind _issue_lock (a slot-waiting leader can
            # hold it for a full wire round)
            if self._durable_lsn >= lsn:
                return None
            if self._issue_lsn >= lsn:
                return self._covering_round_locked(lsn)
        with self._issue_lock:
            salvage: Optional[List[_SalvageSeg]] = None
            with self._commit_cv:
                if self._durable_lsn >= lsn:
                    return None
                if self._issue_lsn >= lsn:
                    return self._covering_round_locked(lsn)
                self._raise_pipe_deferred_locked(issue=True)
                # demand stamp BEFORE the slot wait: a congested pipeline
                # must not dilate the estimator's arrival gaps
                self._ack_est.observe_arrival(time.monotonic())
                self._maybe_grow_locked()
                ok = self._commit_cv.wait_for(
                    lambda: len(self._inflight) < self._depth
                    or self._durable_lsn >= lsn or self._issue_lsn >= lsn,
                    timeout=_remaining(deadline))
                if not ok:
                    self._shrink_locked()   # timeout: back off
                    raise LogError(
                        f"force({lsn}) timed out waiting for a pipeline "
                        f"slot (depth={self._depth})")
                if self._durable_lsn >= lsn:
                    return None
                if self._issue_lsn >= lsn:
                    return self._covering_round_locked(lsn)
                fresh_segs = None
                if self._salvage:
                    # bundle: the stashed deltas AND this leader's own
                    # fresh range ride as ONE pipeline round, so the
                    # fresh bytes can never retire ahead of the hole
                    salvage, self._salvage = self._salvage, []
                    end_lsn = salvage[-1].end_lsn
                    start_off = salvage[0].start_off
                    end_off = salvage[-1].end_off
                    if lsn > end_lsn:
                        fresh_start = end_off % self.cfg.capacity
                        rec = self._recs[lsn]
                        end_lsn = lsn
                        end_off = (rec.off - self.ring_off) + rec.extent
                        fresh_segs = self._range_segs(fresh_start, end_off)
                    entry = _PipeRound(end_lsn, start_off, end_off,
                                       salvage_src=salvage,
                                       gen=self._salvage_gen,
                                       issued_at=time.monotonic())
                else:
                    start_off = self._issue_off
                    rec = self._recs[lsn]
                    end_off = (rec.off - self.ring_off) + rec.extent
                    entry = _PipeRound(lsn, start_off, end_off,
                                       gen=self._salvage_gen,
                                       issued_at=time.monotonic())
                # timeline slot dependency (DESIGN.md §14): with k rounds
                # still in flight this round occupies the slot vacated by
                # the (depth - k)-th most recently retired round, whose
                # end is in _vt_tail (the slot wait above guarantees
                # k < depth, so that round has retired)
                rel = len(self._vt_tail) + len(self._inflight) - self._depth
                entry.vt_after = self._vt_tail[rel] if rel >= 0 else 0.0
                self._inflight.append(entry)
                self._issue_lsn = entry.end_lsn
                self._issue_off = entry.end_off % self.cfg.capacity
                self._issue_seq += 1
            try:
                if salvage is not None:
                    handle = reissue_segs(
                        self.dev, [s.salv for s in salvage], self.repl,
                        self.cfg.ordering,
                        local_durable=self.cfg.local_durable,
                        fresh_segs=fresh_segs)
                    self.salvage_rounds_total += 1
                    self.reissue_bytes_total += handle.reissue_bytes
                    lanes = len(self.repl.live_transports()) \
                        if self.repl is not None else 0
                    self.full_reissue_bytes_total += sum(
                        s.salv.total for s in salvage) * max(lanes, 1)
                else:
                    handle = write_and_force_segs_async(
                        self.dev, self._range_segs(start_off, end_off),
                        self.repl, self.cfg.ordering,
                        local_durable=self.cfg.local_durable)
            except BaseException as exc:
                with self._commit_cv:
                    # surfaced=True: the issuing leader raises it itself
                    self._pipe_fail_locked(entry, exc, surfaced=True)
                raise
            with self._commit_cv:
                entry.handle = handle
        handle.add_done_callback(self._pipe_pump)
        # a bundled stash always extends to at least lsn, so the entry
        # covers the caller in every branch
        return entry

    def _pipe_pump(self) -> None:
        """Retire settled rounds strictly head-first: the durable
        watermark only ever advances over a gapless prefix.  Runs on
        whatever thread settles a round's quorum (a lane worker, or the
        issuing thread inline when the round needed no wire work); a
        failed head round fails every later round."""
        with self._commit_cv:
            while self._inflight:
                entry = self._inflight[0]
                if entry.handle is None or not entry.handle.done():
                    break
                try:
                    vns = entry.handle.wait(timeout=0)
                except Exception as exc:
                    # KeyboardInterrupt/SystemExit must propagate to the
                    # settling thread, not poison the pipeline as a
                    # permanently failed round (PR 10 satellite)
                    self._pipe_fail_locked(entry, exc)
                    break
                self._inflight.popleft()
                now = time.monotonic()
                self._durable_lsn = entry.end_lsn
                self._durable_off = entry.end_off % self.cfg.capacity
                self.force_vns_total += vns
                # place the round on the virtual timeline: its modelled
                # completion is the max over its resource intervals, not
                # the scalar sum — overlapped rounds now overlap in
                # modelled time (DESIGN.md §14)
                vt_end = entry.handle.schedule_on(self.timeline,
                                                  entry.vt_after)
                if vt_end > self._durable_vtime:
                    self._durable_vtime = vt_end
                self._vt_tail.append(vt_end)
                self._clean_retires += 1
                self._ack_est.observe_retire(now, entry.issued_at)
                self._record_ack_locked(entry.end_lsn, now, vns, vt_end)
                if entry.salvage_src:
                    # the salvaged ranges reached their write quorum after
                    # all: durability was achieved, so the failures that
                    # were deferred with no covering waiter are moot
                    for seg in entry.salvage_src:
                        for exc in seg.deferred:
                            try:
                                self._pipe_errors.remove(exc)
                            except ValueError:
                                pass
            self._commit_cv.notify_all()

    def _pipe_fail_locked(self, entry: _PipeRound, exc: BaseException,
                          surfaced: bool = False) -> None:
        """Fail ``entry`` and every round issued after it (in-order
        retirement cannot skip a hole), roll the issue watermark back to
        the last surviving round, and wake every waiter.  ``surfaced``
        means the caller raises ``exc`` itself, so it must not also be
        deferred.  With salvage enabled, a quorum/transport failure no
        longer discards the failed rounds' progress: each one's unacked
        (backup × range) remainder is stashed (LSN order, ahead of any
        older stash — the failed rounds always precede it) so the next
        leader re-issues only the deltas.  The adaptive controller
        halves the effective depth.  Caller holds _commit_cv."""
        try:
            idx = self._inflight.index(entry)
        except ValueError:
            return
        failed: List[_PipeRound] = []
        while len(self._inflight) > idx:
            failed.append(self._inflight.pop())
        failed.reverse()                      # LSN-ascending
        for e in failed:
            e.error = exc
        prev = self._inflight[-1] if self._inflight else None
        self._issue_lsn = prev.end_lsn if prev else self._durable_lsn
        self._issue_off = (prev.end_off % self.cfg.capacity) if prev \
            else self._durable_off
        deferred: Optional[BaseException] = None
        if not surfaced and all(e.waiters == 0 for e in failed):
            # nobody is covering these rounds: defer so the error still
            # surfaces (next force issue with no salvage pending, or
            # drain) — a later successful salvage clears it
            deferred = exc
            self._pipe_errors.append(exc)
        stash: List[_SalvageSeg] = []
        if self.cfg.salvage and isinstance(exc, (QuorumError,
                                                 TransportError)):
            for e in failed:
                if e.gen != self._salvage_gen:
                    # a tombstone rewrote a header inside this round's
                    # range after it was posted: its wire image would
                    # resurrect the record on a backup — never stash it
                    # (the chain check below then drops the rest too)
                    continue
                if e.salvage_src is not None:
                    # a failed salvage round: re-stash its segments with
                    # updated ack sets (acks only ever accumulate); a
                    # bundled fresh range contributes one trailing state
                    # and becomes a salvageable segment of its own
                    srcs = e.salvage_src
                    states = e.handle.salvage_states() \
                        if e.handle is not None else None
                    for i, seg in enumerate(srcs):
                        salv = states[i] if states else seg.salv
                        dfd = list(seg.deferred)
                        if deferred is not None:
                            dfd.append(deferred)
                        stash.append(_SalvageSeg(seg.end_lsn, seg.start_off,
                                                 seg.end_off, salv, dfd,
                                                 seg.attempts + 1))
                    if states is not None and len(states) > len(srcs):
                        stash.append(_SalvageSeg(
                            e.end_lsn,
                            srcs[-1].end_off % self.cfg.capacity,
                            e.end_off, states[len(srcs)],
                            [deferred] if deferred is not None else []))
                elif e.handle is not None:
                    for salv in e.handle.salvage_states():
                        stash.append(_SalvageSeg(
                            e.end_lsn, e.start_off, e.end_off, salv,
                            [deferred] if deferred is not None else []))
        # prepend: rounds failing now always precede any older stash.
        # The stash is only usable if it covers the rolled-back range
        # without a gap: a failed round that contributed nothing (fatal
        # non-transport error, no wire round) would leave a hole that a
        # later salvage retirement would silently mark durable — verify
        # the chain from the issue watermark and drop everything on a
        # mismatch (the next leader falls back to a full fresh re-issue).
        merged = stash + self._salvage
        pos = self._issue_off
        chained = True
        for s in merged:
            if s.start_off != pos:
                chained = False
                break
            pos = s.end_off % self.cfg.capacity
        self._salvage = merged if chained else []
        self._enforce_stash_cap_locked()
        self._shrink_locked()
        self._commit_cv.notify_all()

    def _enforce_stash_cap_locked(self) -> None:
        """Bound the wire-image bytes the salvage stash pins during an
        outage (LogConfig.salvage_stash_cap).  Spills OLDEST-first: the
        front (lowest-LSN) segments have been unresolved longest.  Only
        the held _StagedWrite images are dropped — the segment's chain
        metadata and ack credits survive, and a None-staged lane is
        re-snapshotted from the primary device at re-issue time (correct
        even across a tombstone: the re-read sees current media bytes).
        The price is a fresh DMA read and a full-range re-send for the
        spilled lanes, accounted in salvage_spilled_*."""
        cap = self.cfg.salvage_stash_cap
        if cap is None or not self._salvage:
            return
        held = sum(st.total for seg in self._salvage
                   for _, st in seg.salv.pending if st is not None)
        for seg in self._salvage:
            if held <= cap:
                return
            pend = seg.salv.pending
            for j, (t, st) in enumerate(pend):
                if st is None:
                    continue
                pend[j] = (t, None)
                held -= st.total
                self.salvage_spilled_images += 1
                self.salvage_spilled_bytes += st.total
                if held <= cap:
                    return

    def _raise_pipe_deferred_locked(self, issue: bool = False) -> None:
        """Surface the deferred round failures.  At force-issue time
        (``issue=True``) errors whose rounds sit in the salvage stash are
        held back — the leader is about to retry exactly those rounds,
        and a successful salvage voids them; drain still surfaces
        everything (durability has NOT been achieved yet).

        A storm of failed ``wait=False`` rounds queues one error per
        round; they surface COALESCED — every surfaceable error leaves
        the backlog at once, the oldest is raised, and the rest ride on
        it as ``exc.pipe_backlog`` — so one drain (or one force) settles
        the whole storm instead of surfacing one error per call."""
        if not self._pipe_errors:
            return
        if issue:
            # an error is only "pending retry" while its segment has
            # salvage budget left; past the limit it surfaces now
            pending = {id(exc) for seg in self._salvage
                       if seg.attempts < _SALVAGE_RETRY_LIMIT
                       for exc in seg.deferred}
            for e in self._inflight:
                # a salvage round already re-issuing those ranges: its
                # verdict (retire clears them / failure re-stashes them)
                # is still out
                if e.salvage_src:
                    pending.update(id(exc) for seg in e.salvage_src
                                   for exc in seg.deferred)
            surfaceable = [e for e in self._pipe_errors
                           if id(e) not in pending]
        else:
            surfaceable = list(self._pipe_errors)
        if not surfaceable:
            return
        for e in surfaceable:
            self._pipe_errors.remove(e)
        exc = surfaceable[0]
        exc.pipe_backlog = tuple(surfaceable[1:])
        raise exc

    def _pipe_await(self, lsn: int, entry: Optional[_PipeRound],
                    deadline: Optional[float]) -> int:
        """Block until ``lsn`` is durable (its covering round — and every
        earlier one — retired) or its covering round failed."""
        with self._commit_cv:
            if entry is not None:
                entry.waiters += 1
            try:
                ok = self._commit_cv.wait_for(
                    lambda: self._durable_lsn >= lsn
                    or (entry is not None and entry.error is not None),
                    timeout=_remaining(deadline))
            finally:
                if entry is not None:
                    entry.waiters -= 1
            if self._durable_lsn >= lsn:
                return self._durable_lsn
            if entry is not None and entry.error is not None:
                # this waiter surfaces the failure: drop any deferred
                # copy stashed before the waiter registered (race)
                try:
                    self._pipe_errors.remove(entry.error)
                except ValueError:
                    pass
                raise entry.error
            if not ok:
                raise LogError(f"force({lsn}) timed out waiting for round "
                               f"{entry.end_lsn if entry else lsn} to "
                               f"retire")
            return self._durable_lsn

    def drain(self, timeout: Optional[float] = None,
              surface_errors: bool = True) -> None:
        """Wait until every issued durability round has retired, then
        surface any deferred pipeline error (a ``wait=False`` round that
        failed with no covering waiter) and any straggler-lane error the
        replication group harvested.  Does not issue new rounds:
        completed-but-unforced records stay in the vulnerability window
        (use a force policy's ``drain`` to force them first).

        With ``surface_errors=False`` only the wait happens — deferred
        errors stay stashed for the next force/drain.  Failover uses
        this (ClusterManager._drain_logs) so settling the pipeline
        before the epoch fence cannot destroy a failure signal.

        Every deferred error surfaces in ONE coalesced raise: the
        oldest pipeline failure (with the rest of the pipeline backlog
        AND any harvested replication-lane errors riding on
        ``exc.pipe_backlog``), so after one failing drain the next is
        clean — an error storm costs the app exactly one exception."""
        pipe_exc: Optional[BaseException] = None
        with self._commit_cv:
            ok = self._commit_cv.wait_for(lambda: not self._inflight,
                                          timeout=timeout)
            if not ok:
                raise LogError("drain timed out with durability rounds "
                               "still in flight")
            if surface_errors:
                try:
                    self._raise_pipe_deferred_locked()
                except BaseException as exc:
                    pipe_exc = exc
        if self.repl is not None:
            try:
                self.repl.drain(timeout=timeout,
                                surface_errors=surface_errors)
            except BaseException as exc:
                if pipe_exc is None:
                    raise
                pipe_exc.pipe_backlog = (
                    tuple(getattr(pipe_exc, "pipe_backlog", ()))
                    + (exc,) + tuple(getattr(exc, "pipe_backlog", ())))
        if pipe_exc is not None:
            raise pipe_exc

    def abandon_salvage(self) -> None:
        """Drop the salvage stash (failed rounds awaiting re-issue).

        Failover uses this (ClusterManager._drain_logs): once the old
        primary is about to be fenced, its snapshotted wire images must
        never reach a backup under the old epoch — the new primary
        re-establishes the tail through quorum recovery instead.  Any
        deferred failure stays stashed and still surfaces on the next
        force/drain."""
        with self._commit_cv:
            self._salvage.clear()

    def append(self, data: bytes, freq: int = 1) -> int:
        """Convenience bundle of reserve+copy+complete+force (Table 2)."""
        rec_id, view = self.reserve(len(data))
        if view is not None:
            view[:] = data
        else:
            self.copy(rec_id, data)
        self.complete(rec_id)
        self.force(rec_id, freq=freq)
        return rec_id

    def append_timed(self, data: bytes, freq: int = 1,
                     per_record: bool = False):
        """append + modelled hardware ns (benchmark instrumentation).

        With ``per_record=True`` also returns the record's durable-ack
        wall timestamp (``durable_ack_time``; None while a freq policy
        left it unforced) as a third element."""
        rec_id, view = self.reserve(len(data))
        vns = 0.0
        if view is not None:
            view[:] = data
            vns += self.dev.cost.store_byte_ns * len(data)
        else:
            vns += self.copy(rec_id, data)
        vns += self.complete(rec_id)
        self.force(rec_id, freq=freq)
        # charge exactly the round that covered this record — a
        # force_vns_total delta across the unlocked force would also
        # bill every concurrent leader's round and salvage retry to
        # this caller (PR 10 satellite)
        vns += self.durable_round_vns(rec_id) or 0.0
        if per_record:
            return rec_id, vns, self.durable_ack_time(rec_id)
        return rec_id, vns

    # ------------------------------------------------------------------ #
    # batched write path (DESIGN.md §3)
    # ------------------------------------------------------------------ #
    def reserve_batch(self, sizes: List[int]) -> Batch:
        """Serialized: allocate space + LSNs for N records under ONE
        _alloc_lock acquisition.

        Allocation is planned against a shadow of the tail state first and
        only committed if every record fits, so a LogFullError leaves no
        partially-reserved state behind.  Ring wrap emits a PAD record (or
        the implicit header-doesn't-fit skip) exactly like the scalar
        path.  Headers are staged in DRAM segment buffers and reach the
        device in complete_batch — the provisional flags=0 header the
        scalar path publishes is unobservable here because reserve and
        complete happen inside one call, with no force in between.
        """
        for size in sizes:
            if size < 0 or _align8(REC_HDR_SIZE + size) > self.cfg.capacity:
                raise ValueError("bad record size")
        batch = Batch(lsns=[], sizes=list(sizes))
        if not sizes:
            return batch
        try:
            with self._alloc_lock:
                fire = self._reserve_batch_locked(sizes, batch)
        except LogFullError:
            # the plan phase is pure, so the failed attempt left no
            # partial state: run the lifecycle reclaim and retry once
            if not self._reclaim_on_full():
                raise
            with self._alloc_lock:
                fire = self._reserve_batch_locked(sizes, batch)
        if fire:
            self._space_low_pending = True    # fired at complete_batch
        return batch

    def _reserve_batch_locked(self, sizes: List[int], batch: Batch) -> bool:
        # plan (pure): mirror _fit over a shadow tail
        tail, used = self._tail_off, self._used
        plan: List[Tuple[str, int, int, int]] = []  # kind, off, size, extent
        for size in sizes:
            extent = _align8(REC_HDR_SIZE + size)
            room = self.cfg.capacity - tail
            off, pad_room = (tail, None) if extent <= room else (0, room)
            need = extent + (pad_room or 0)
            if used + need > self.cfg.capacity:
                raise LogFullError(
                    f"log full: used={used} need={need} "
                    f"cap={self.cfg.capacity}")
            if pad_room is not None and pad_room >= REC_HDR_SIZE:
                plan.append(("pad", tail, pad_room - REC_HDR_SIZE,
                             pad_room))
            elif pad_room is not None and pad_room > 0:
                plan.append(("skip", tail, 0, pad_room))
            plan.append(("rec", off, size, extent))
            tail = off + extent
            used += need
        # commit: lay records out over contiguous segments (a "skip"
        # or a wrap breaks continuity), then build _Recs + buffers
        seg_starts: List[int] = []
        seg_lens: List[int] = []
        placed: List[Tuple[str, int, int, int, int, int]] = []
        prev_end = -1
        for kind, off, size, extent in plan:
            if kind == "skip":
                prev_end = -1       # stale bytes stay untouched
                continue
            if off != prev_end:
                seg_starts.append(off)
                seg_lens.append(0)
            si = len(seg_starts) - 1
            placed.append((kind, off, size, extent, si, seg_lens[si]))
            seg_lens[si] += extent
            prev_end = off + extent
        batch._segs = [_BatchSeg(s, bytearray(l))
                       for s, l in zip(seg_starts, seg_lens)]
        lsn = self._next_lsn
        recs, abs_base = self._recs, self.ring_off
        for kind, off, size, extent, si, hdr_off in placed:
            if kind == "pad":
                buf = batch._segs[si].buf
                buf[hdr_off : hdr_off + REC_HDR_SIZE] = _REC_HDR.pack(
                    lsn, size, 0, FLAG_VALID | FLAG_PAD)
                recs[lsn] = _Rec(lsn, abs_base + off, size, extent,
                                 pad=True)
                batch._pad_lsns.append(lsn)
            else:
                rec = _Rec(lsn, abs_base + off, size, extent)
                recs[lsn] = rec
                batch.lsns.append(lsn)
                batch._items.append((rec, si, hdr_off + REC_HDR_SIZE))
            lsn += 1
        self._next_lsn = lsn
        self._tail_off = tail
        self._used = used
        return self._space_low_check_locked()

    def copy_batch(self, batch: Batch, payloads: List[bytes]) -> float:
        """Concurrent: stage all payload bytes (ntstore cost model)."""
        if len(payloads) != len(batch.lsns):
            raise ValueError(
                f"batch holds {len(batch.lsns)} records, got "
                f"{len(payloads)} payloads")
        total = 0
        for i, data in enumerate(payloads):
            rec, seg_idx, pay_off = batch._items[i]
            if len(data) > rec.size:
                raise ValueError("copy out of record bounds")
            buf = batch._segs[seg_idx].buf
            buf[pay_off : pay_off + len(data)] = data
            total += len(data)
        return self.dev.cost.store_byte_ns * total

    def complete_batch(self, batch: Batch) -> float:
        """Concurrent: checksum every payload in one sweep, pack all
        headers, publish each staged segment with ONE device write, and
        advance the complete watermark with ONE _commit_cv pass.  Every
        FLAG_PHASH payload of the wave is hashed in ONE batched launch
        (the same values the per-record hash gives)."""
        if batch._completed:
            raise LogError("batch already completed")
        batch._completed = True
        vns = 0.0
        crc_bytes = 0
        views = [memoryview(seg.buf) for seg in batch._segs]
        pack, threshold = _REC_HDR.pack, self.cfg.phash_threshold
        ph: List[Tuple[memoryview, int, int, int]] = []
        for rec, seg_idx, pay_off in batch._items:
            mv = views[seg_idx]
            size = rec.size
            payload = mv[pay_off : pay_off + size]
            if threshold is not None and size >= threshold:
                ph.append((mv, pay_off, rec.lsn, size))
            else:
                mv[pay_off - REC_HDR_SIZE : pay_off] = pack(
                    rec.lsn, size, _rec_crc(rec.lsn, size, payload),
                    FLAG_VALID)
            crc_bytes += size
        if ph:
            vals = _phash_many([(lsn, size, mv[off : off + size])
                                for mv, off, lsn, size in ph], self.device)
            for (mv, off, lsn, size), crc in zip(ph, vals.tolist()):
                mv[off - REC_HDR_SIZE : off] = pack(
                    lsn, size, crc, FLAG_VALID | FLAG_PHASH)
        for seg in batch._segs:
            vns += self.dev.write(self._abs(seg.ring_off), seg.buf)
        vns += self.dev.cost.crc_byte_ns * crc_bytes
        self._mark_complete_many(batch._pad_lsns + batch.lsns)
        if self._space_low_pending:
            self._space_low_pending = False
            self._fire_space_low()
        return vns

    def force_batch(self, batch: Batch, freq: int = 1,
                    timeout: Optional[float] = None,
                    wait: bool = True) -> int:
        """Force the batch per the frequency policy: the largest batch LSN
        that is ≡ 0 (mod freq) leads for everything up to itself (exactly
        the forces the scalar loop would have issued).  The force itself
        issues one coalesced byte range — one flush+fence (two across a
        wrap) and one replication round for the whole batch."""
        if not batch.lsns:
            with self._commit_cv:
                return self._durable_lsn
        if freq <= 1:
            return self.force(batch.lsns[-1], freq=1, timeout=timeout,
                              wait=wait)
        leaders = [l for l in batch.lsns if l % freq == 0]
        if not leaders:
            with self._commit_cv:
                return self._durable_lsn
        return self.force(leaders[-1], freq=freq, timeout=timeout, wait=wait)

    def append_batch(self, payloads: List[bytes], freq: int = 1) -> List[int]:
        """Batched reserve+copy+complete+force: the Table-2 pipeline with
        per-batch instead of per-record bookkeeping."""
        batch = self.reserve_batch([len(p) for p in payloads])
        self.copy_batch(batch, payloads)
        self.complete_batch(batch)
        self.force_batch(batch, freq=freq)
        return batch.lsns

    def append_batch_timed(self, payloads: List[bytes], freq: int = 1,
                           per_record: bool = False):
        """append_batch + modelled hardware ns (benchmark instrumentation).

        With ``per_record=True`` also returns one durable-ack wall
        timestamp PER RECORD (``durable_ack_time``) as a third element:
        each member is stamped with the retirement of its own covering
        round, not a batch average — members that landed in different
        pipeline rounds carry different stamps, and members a freq
        policy left unforced carry None.  This is what makes batch p99
        claims record-level truth."""
        batch = self.reserve_batch([len(p) for p in payloads])
        vns = self.copy_batch(batch, payloads)
        vns += self.complete_batch(batch)
        self.force_batch(batch, freq=freq)
        # sum the DISTINCT rounds that covered the batch's members (not
        # a force_vns_total delta, which raced with concurrent leaders)
        vns += self.durable_rounds_vns(batch.lsns)
        if per_record:
            return batch.lsns, vns, \
                [self.durable_ack_time(l) for l in batch.lsns]
        return batch.lsns, vns

    # observability ------------------------------------------------------ #
    @property
    def durable_lsn(self) -> int:
        with self._commit_cv:
            return self._durable_lsn

    @property
    def durable_vtime(self) -> float:
        """Modelled vtime (vns) at which the latest retired round ended
        on the virtual timeline — the log's modelled durability *time*.
        Monotone; equals ``force_vns_total`` exactly when rounds never
        overlap (blocking forces at pipeline depth 1), and falls below
        it by the overlap the pipeline achieves (DESIGN.md §14)."""
        with self._commit_cv:
            return self._durable_vtime

    def modelled_time_ns(self) -> float:
        """Modelled wall clock of everything charged to this log's
        timeline: durability rounds plus background work (scrub reads)
        scheduled on other resources."""
        with self._commit_cv:
            dv = self._durable_vtime
        return max(dv, self.timeline.makespan())

    @property
    def completed_lsn(self) -> int:
        with self._commit_cv:
            return self._complete_upto

    @property
    def next_lsn(self) -> int:
        with self._alloc_lock:
            return self._next_lsn

    def vulnerability_window(self) -> int:
        """Completed-but-unforced records (Fig. 8c/d metric)."""
        with self._commit_cv:
            return max(0, self._complete_upto - self._durable_lsn)

    def inflight_span(self) -> int:
        """LSNs issued into the pipeline but not yet durable.  In-flight
        rounds are contiguous (retirement is strictly head-first and a
        failure rolls the issue watermark back to the last survivor), so
        the issued-minus-durable difference IS the sum of the in-flight
        rounds' spans — the live per-round-span term of the tightened
        vulnerability bound (ForcePolicy.effective_vulnerability_bound)."""
        with self._commit_cv:
            return max(0, self._issue_lsn - self._durable_lsn)

    def vulnerability_bound(self, freq: int) -> int:
        """Theoretical worst case F × T (§4.4)."""
        return freq * self.cfg.max_threads

    # ------------------------------------------------------------------ #
    # space reclamation
    # ------------------------------------------------------------------ #
    def read_trim_watermark(self) -> Optional[int]:
        """Decode the durable trim watermark slot; None when the word
        fails its embedded check (zeroed/torn-by-rot/alien media)."""
        return _trim_decode(self.dev.read(self.trim_off, TRIM_SLOT_SIZE))

    def trim(self, upto_lsn: int,
             _crash_hook=None) -> float:
        """Bulk truncate: reclaim every record at or below ``upto_lsn``
        (DESIGN.md §13).

        The commit point is the watermark flush — ONE 8-byte-atomic
        store + flush of the dedicated slot, replicated on the live
        lanes.  A crash before it recovers the pre-trim view; any crash
        after it recovers the post-trim view (recovery adopts the
        watermark even when the superline publish never happened).  The
        slot is a single PMEM persist unit, so no torn state exists.

        Reclamation is O(1) in device work: no per-record tombstone
        writes or replication rounds — the ring bytes stay in place and
        simply fall outside the recovery scan once the head passes them
        (the volatile record map drops its entries, an O(trimmed)
        DRAM-only sweep).  Only durable records may be trimmed: the
        caller (checkpoint GC) must have committed an application
        snapshot covering them first.  ``upto_lsn`` below the head is a
        no-op, beyond the durable watermark a TrimError.

        ``_crash_hook`` is fault-injection plumbing: called with the
        stage name at each ordering point; raising aborts mid-trim
        exactly there (the harnesses then crash the device).
        """
        hook = _crash_hook or (lambda stage: None)
        with self._alloc_lock, self._issue_lock:
            # _issue_lock too: serializes the slot/superline publishes
            # against a resync cut-over reading the meta region, and is
            # the same order cleanup's guard path takes (_alloc_lock
            # outer, _issue_lock inner, _commit_cv innermost).
            with self._commit_cv:
                if upto_lsn > self._durable_lsn:
                    raise TrimError(
                        f"trim({upto_lsn}) beyond durable watermark "
                        f"{self._durable_lsn}: un-acked records cannot "
                        f"be declared checkpointed")
                if upto_lsn < self._head_lsn:
                    return 0.0
                nxt = self._recs.get(upto_lsn + 1)
                new_head_off = (nxt.off - self.ring_off) if nxt is not None \
                    else self._tail_off
            # 1) commit point: advance the durable watermark.  Salvage
            #    stash images and in-flight rounds only cover ranges
            #    above the durable watermark, so they are disjoint from
            #    everything this trim touches — no exclusion needed.
            hook("pre_watermark")
            vns = self.dev.write(self.trim_off, _trim_encode(upto_lsn))
            hook("pre_watermark_flush")
            vns += write_and_force(self.dev, self.trim_off, TRIM_SLOT_SIZE,
                                   self.repl, self.cfg.ordering,
                                   local_durable=self.cfg.local_durable)
            hook("post_watermark")
            # 2) O(1) device bookkeeping: drop the volatile entries and
            #    advance the head over the whole span at once
            with self._commit_cv:
                n_trimmed = 0
                for lsn in range(self._head_lsn, upto_lsn + 1):
                    if self._recs.pop(lsn, None) is not None:
                        n_trimmed += 1
                cap = self.cfg.capacity
                span = (new_head_off - self._head_off) % cap
                # span 0 with a non-empty trim == the reclaimed range
                # wrapped the whole ring (every live byte was trimmed)
                freed = span if span > 0 else self._used
                self._used -= freed
                self._head_lsn = upto_lsn + 1
                self._head_off = new_head_off
                self._trim_lsn = upto_lsn
                self.trimmed_records_total += n_trimmed
                self.trimmed_bytes_total += freed
                self._rearm_space_low_locked()
            # 3) publish the advanced head (two-copy atomic superline,
            #    replicated) — pure acceleration: recovery adopts the
            #    post-trim view from the watermark alone
            vns += self._write_superline()
            hook("post_superline")
        return vns

    def cleanup(self, rec_id: int) -> float:
        """Tombstone one record; advance the head over any contiguous
        reclaimed prefix and publish it in the superline."""
        with self._alloc_lock:
            rec = self._recs.get(rec_id)
            if rec is None:
                return 0.0
            with self._commit_cv:
                # Salvage stash segments and staged wire images only ever
                # cover ranges ABOVE the durable watermark, so tombstoning
                # a durable record (the normal GC path) needs no exclusion
                # at all.  Tombstoning a not-yet-durable record is the
                # rare case where a stale pre-tombstone image could reach
                # a lane AFTER the tombstone and resurrect the record on a
                # backup: serialize with the issue path then — _issue_lock
                # keeps a leader from posting a stash it popped before the
                # generation bump (a stuck pipeline can make this wait;
                # the durable-record path never pays it).
                guard = rec.lsn > self._durable_lsn
            if not guard:
                return self._cleanup_rec_locked(rec)
            with self._issue_lock:
                with self._commit_cv:
                    # drop the stash and bump the generation so a round
                    # posted before this tombstone can never be stashed
                    # when it fails later (full fresh re-issue instead)
                    self._salvage.clear()
                    self._salvage_gen += 1
                return self._cleanup_rec_locked(rec)

    def _cleanup_rec_locked(self, rec: _Rec) -> float:
        """Tombstone body; caller holds _alloc_lock (+ _issue_lock when
        the record may sit inside a salvage/staged range)."""
        raw = self.dev.read(rec.off, REC_HDR_SIZE)
        lsn, size, crc, flags = _REC_HDR.unpack(raw)
        vns = self.dev.write(rec.off, _REC_HDR.pack(
            lsn, size, crc, (flags | FLAG_CLEANED) & ~FLAG_VALID))
        vns += write_and_force(self.dev, rec.off, REC_HDR_SIZE, self.repl,
                               self.cfg.ordering,
                               local_durable=self.cfg.local_durable)
        # advance head over contiguous cleaned/pad records
        advanced = False
        while True:
            head = self._recs.get(self._head_lsn)
            if head is None:
                break
            hraw = self.dev.read(head.off, REC_HDR_SIZE)
            _, _, _, hflags = _REC_HDR.unpack(hraw)
            reclaimable = head.pad or (hflags & FLAG_CLEANED)
            if not reclaimable or self._head_lsn > self._durable_lsn:
                break
            self._used -= head.extent
            self._head_off = (head.off - self.ring_off + head.extent) \
                % self.cfg.capacity
            del self._recs[self._head_lsn]
            self._head_lsn += 1
            advanced = True
        if advanced:
            self._rearm_space_low_locked()
            vns += self._write_superline()
        return vns

    def cleanupAll(self) -> float:
        """Reinitialize the whole log, preserving the epoch (§4.3)."""
        with self._alloc_lock, self._commit_cv:
            self._recs.clear()
            self._head_lsn = self._start_lsn = self._next_lsn
            self._head_off = self._tail_off = 0
            self._used = 0
            self._complete_upto = self._durable_lsn = self._next_lsn - 1
            self._durable_off = 0
            self._inflight.clear()
            self._pipe_errors.clear()
            self._salvage.clear()
            self._salvage_gen += 1
            self._issue_lsn = self._durable_lsn
            self._issue_off = 0
            self._rearm_space_low_locked()
            return self._write_superline()

    # ------------------------------------------------------------------ #
    # recovery (local copy) — vectorized scan (DESIGN.md §5)
    # ------------------------------------------------------------------ #
    def _ring_snapshot(self) -> torch.Tensor:
        """ONE device read of the whole ring (newest visible bytes), as a
        CPU uint8 tensor.  The scan and the recovery iterator parse
        headers and serve payloads out of this snapshot instead of
        issuing per-record dev.read calls (the pre-PR2 scan did two
        reads per record)."""
        return self.dev.read_tensor(self.ring_off, self.cfg.capacity)

    def _plan_scan_vectorized(self, raw: torch.Tensor, start_pos: int,
                              start_lsn: int, start_used: int
                              ) -> Optional[_ScanPlan]:
        """Planned vectorized pass over the LSN chain from a walk state.

        Preconditions (the prefix walk in _recover_local guarantees them):
        ``start_pos`` is a legal header position (8-aligned, a full header
        fits or pos == 0), ``start_used`` < capacity, and ``start_lsn`` >=
        _LSN_VEC_MIN so no on-media *flags* word (4 bits today) can
        collide with an expected chain LSN.

        Every record offset is 8-aligned, so candidate headers live on the
        8-byte slot grid.  One boolean mask over the u64 view finds every
        slot whose first word is a plausible chain LSN; the chain is then
        resolved by expected-LSN lookup and verified link-by-link with
        array arithmetic (position chain, flag validity, extent bounds,
        ring-budget entry condition) — the same checks the scalar walk
        made per record, applied to all records at once.  Returns None
        when a chain LSN matches more than one slot (payload bytes can
        still masquerade as headers); the caller falls back to the
        sequential walk, which disambiguates positionally.
        """
        cap = self.cfg.capacity
        # int64 view of the u64 words: a value with the top bit set goes
        # negative and fails ``>= lo`` exactly as the unsigned value
        # fails ``< lo + max_recs``
        u64 = raw.view(torch.int64)
        lo = start_lsn
        # chain length is bounded by the ring budget (min extent = header)
        max_recs = cap // REC_HDR_SIZE + 2
        mask = (u64 >= lo) & (u64 < lo + max_recs)
        cand = torch.nonzero(mask).flatten()

        if cand.numel() == 0:
            return _ScanPlan([], start_pos, start_used, lo)
        sl, order = torch.sort(u64[cand], stable=True)
        sp = cand[order]
        n_targets = int(sl[-1]) - lo + 1
        targets = torch.arange(lo, lo + n_targets, dtype=torch.int64)
        first = torch.searchsorted(sl, targets)
        last = torch.searchsorted(sl, targets, right=True)
        n0 = _first_true(first >= last, n_targets)
        if n0 == 0:
            return _ScanPlan([], start_pos, start_used, lo)
        if bool(((last[:n0] - first[:n0]) > 1).any()):
            return None  # ambiguous candidates: sequential walk decides

        slots = sp[first[:n0]]
        pos = slots * 8
        # gather (size, crc) of the header at slot u from the int32 view
        # (words 2u+2, 2u+3: the u32 pair after the lsn word), widened and
        # masked, and flags via the u64 view two words in; clip tail-end
        # slot indices (a header there can never pass the link check).
        n_slots = (cap - REC_HDR_SIZE) // 8 + 1
        i32 = raw.view(torch.int32)
        safe = torch.clamp(slots, max=n_slots - 1)
        sz = i32[2 * safe + 2].to(torch.int64) & 0xFFFFFFFF
        cr = i32[2 * safe + 3].to(torch.int64) & 0xFFFFFFFF
        fl = u64[torch.clamp(slots + 2, max=u64.numel() - 1)]
        ext = (REC_HDR_SIZE + sz + 7) & ~7

        zero = torch.zeros_like(pos)
        nxt = pos + ext
        in_skip = (nxt < cap) & (cap - nxt < REC_HDR_SIZE)
        skip = torch.where(in_skip, cap - nxt, zero)
        tail_nocap = torch.where(nxt >= cap, zero, nxt)    # pre-skip wrap map
        pos_next = torch.where(in_skip, zero, tail_nocap)  # next examined pos
        pred = torch.empty(n0, dtype=torch.int64)
        pred[0] = start_pos
        pred[1:] = pos_next[:-1]
        used_after = torch.cumsum(ext + skip, 0) + start_used  # + trailing skip
        entry_used = torch.empty(n0, dtype=torch.int64)
        entry_used[0] = start_used
        entry_used[1:] = used_after[:-1]

        other_bad = ((pos != pred)
                     | ((fl & (FLAG_VALID | FLAG_CLEANED)) == 0)
                     | ((pos + ext > cap) & ((fl & FLAG_PAD) == 0)))
        entry_bad = entry_used >= cap
        first_other = _first_true(other_bad, n0)
        first_entry = _first_true(entry_bad, n0)

        def exit_state(k: int) -> Tuple[int, int]:
            """(tail, used) as the scalar walk would leave them when the
            record at ordinal k is the first it does not examine/admit
            (chain end, header mismatch, or ring budget exhausted)."""
            if k == 0:
                return start_pos, start_used
            u_nos = int(entry_used[k - 1]) + int(ext[k - 1])
            if u_nos >= cap:
                return int(tail_nocap[k - 1]), u_nos
            if skip[k - 1] > 0:
                return 0, u_nos + int(skip[k - 1])
            return int(nxt[k - 1]), u_nos

        if first_entry <= first_other and first_entry < n0:
            # ring budget exhausted before record first_entry was
            # examined (k >= 1 because entry_used[0] < cap; and when
            # u_nos < cap, entry_bad implies skip[k-1] > 0, so
            # exit_state's third arm is unreachable here)
            k = first_entry
            tail, used = exit_state(k)
            n1 = k
        elif first_other < n0:
            k = first_other
            tail, used = int(pred[k]), int(entry_used[k])
            n1 = k
        else:
            n1 = n0
            tail, used = exit_state(n0)

        recs = list(zip(pos[:n1].tolist(), sz[:n1].tolist(),
                        cr[:n1].tolist(), fl[:n1].tolist(),
                        ext[:n1].tolist(), entry_used[:n1].tolist()))
        return _ScanPlan(recs, tail, used, lo + n1)

    def _walk_chain(self, raw: torch.Tensor, pos: int, lsn: int, used: int,
                    stop_lsn: Optional[int] = None
                    ) -> Tuple[_ScanPlan, bool]:
        """Sequential chain walk over the snapshot, structurally identical
        to the pre-PR2 scan minus the per-record device reads (payload
        checksums are validated in a later batched pass for both
        planners).  With ``stop_lsn``, stops *before* examining that LSN
        at a legal position and returns handoff=True — the state then
        satisfies the vectorized planner's preconditions.  Also the
        fallback when candidate resolution is ambiguous, and the
        reference the equivalence tests compare against.
        """
        cap = self.cfg.capacity
        unpack_from = _REC_HDR.unpack_from
        buf = raw.numpy()
        recs: List[Tuple[int, int, int, int, int, int]] = []
        while used < cap:
            if cap - pos < REC_HDR_SIZE and pos != 0:
                used += cap - pos
                pos = 0  # slot too small for a header: implicit wrap
                continue
            if stop_lsn is not None and lsn >= stop_lsn:
                return _ScanPlan(recs, pos, used, lsn), True
            got, size, crc, flags = unpack_from(buf, pos)
            if got != lsn:
                break
            extent = _align8(REC_HDR_SIZE + size)
            if pos + extent > cap and not (flags & FLAG_PAD):
                break
            if not (flags & (FLAG_VALID | FLAG_CLEANED)):
                break  # reserved but never completed => end of log
            recs.append((pos, size, crc, flags, extent, used))
            used += extent
            nxt = pos + extent
            pos = 0 if nxt >= cap else nxt
            lsn += 1
        return _ScanPlan(recs, pos, used, lsn), False

    def _recover_local(self) -> None:
        s = self.read_superline()
        if s is None:
            raise CorruptLogError("no valid superline copy")
        if s.capacity != self.cfg.capacity:
            raise CorruptLogError(
                f"capacity mismatch: media={s.capacity} cfg={self.cfg.capacity}")
        self._epoch = s.epoch
        self._head_lsn = s.head_lsn
        self._start_lsn = s.start_lsn
        self._head_off = s.head_off
        # scan forward from the head to find the tail (§4.1: no tail
        # pointer): snapshot once, plan the chain, then batch-validate
        # payload checksums and truncate at the first failure.  LSNs
        # below _LSN_VEC_MIN walk sequentially first (their values can
        # collide with on-media flags words); the remainder goes through
        # the vectorized planner.
        raw = self._ring_snapshot()
        lo = s.head_lsn
        plan, handoff = self._walk_chain(raw, s.head_off, lo, 0,
                                         stop_lsn=max(lo, _LSN_VEC_MIN))
        recs, tail, used, next_lsn = (plan.recs, plan.tail, plan.used,
                                      plan.next_lsn)
        if handoff:
            vec = None
            if tail % 8 == 0:
                vec = self._plan_scan_vectorized(raw, tail, next_lsn, used)
            if vec is None:
                vec, _ = self._walk_chain(raw, tail, next_lsn, used)
            recs = recs + vec.recs
            tail, used, next_lsn = vec.tail, vec.used, vec.next_lsn
        # durable trim watermark (DESIGN.md §13): a valid slot the
        # header chain reaches marks everything at or below it as
        # checkpointed-and-dead — recovery adopts the post-trim view
        # (the crash-between-watermark-and-superline window) and,
        # crucially, skips payload validation for the dead prefix: only
        # the surviving tail pays the checksum pass (the O(tail) bound).
        # A slot that fails its check, or claims an LSN the chain from
        # the superline head cannot reach, is stale rot/corruption:
        # ignore it and keep the full-scan view — never wedge.
        trim = self.read_trim_watermark()
        adopt = trim is not None and trim >= lo and next_lsn > trim
        skip_upto = trim if adopt else lo - 1
        bad = _first_bad_payload(
            raw, ((k, r[0], lo + k, r[1], r[2], r[3])
                  for k, r in enumerate(recs)
                  if lo + k > skip_upto
                  and r[3] & FLAG_VALID
                  and not (r[3] & (FLAG_PAD | FLAG_CLEANED))),
            self.device)
        if bad is not None:
            tail, used, next_lsn = recs[bad][0], recs[bad][5], lo + bad
            recs = recs[:bad]
        if adopt:
            # drop <= len(recs): the chain check above guarantees the
            # scan admitted every record up to the watermark, and a
            # payload truncation can only land above it
            drop = trim - lo + 1
            kept = recs[drop:]
            if kept:
                self._head_off = kept[0][0]
                used -= kept[0][5]      # entry_used is old-head-relative
            else:
                self._head_off = tail   # live window now empty
                used = 0
            recs = kept
            lo = trim + 1
            self._head_lsn = lo
        abs_base = self.ring_off
        rmap = self._recs
        for k, (pos, size, crc, flags, extent, _) in enumerate(recs):
            lsn = lo + k
            rmap[lsn] = _Rec(lsn, abs_base + pos, size, extent, state=FORCED,
                             pad=bool(flags & FLAG_PAD))
        self._next_lsn = next_lsn
        self._tail_off = tail
        self._used = used
        self._complete_upto = self._durable_lsn = next_lsn - 1
        self._durable_off = tail
        self._issue_lsn = self._durable_lsn
        self._issue_off = tail
        self._trim_lsn = trim if (trim is not None
                                  and trim < self._head_lsn) else 0
        # recovered records were acked in a previous life: no wall
        # timestamps exist for them in this process
        self._ack_base = self._durable_lsn
        if adopt and self._head_lsn > s.head_lsn:
            # finish the interrupted trim: republish the advanced head.
            # Best effort — replication may be down at open time; the
            # watermark alone keeps this recovery idempotent.
            try:
                self._write_superline()
            except (QuorumError, TransportError):
                pass

    def iter_records(self, upto: Optional[int] = None
                     ) -> Iterator[Tuple[int, bytes]]:
        """Recovery iterator: yields (lsn, payload) for every live record
        from the head, skipping pads and tombstones (§4.3).

        Serves headers *and* payloads from one ring snapshot — a single
        device read per iteration instead of two per record — and
        validates every payload checksum up front in the same batched
        pass the recovery scan uses (CorruptLogError before the first
        yield, so a corrupt log never surfaces a partial replay).

        ``upto`` bounds the replay to LSNs <= upto — a snapshot-cut
        watermark (DESIGN.md §12): records beyond the cut are neither
        validated nor yielded, so a cut view of a live log never trips
        over a record that was still being staged when the cut froze."""
        with self._alloc_lock:
            items = sorted(self._recs.items())
            raw = self._ring_snapshot()
        live: List[Tuple[int, int, int, int, int, int]] = []
        unpack_from = _REC_HDR.unpack_from
        buf = raw.numpy()
        for lsn, rec in items:
            if upto is not None and lsn > upto:
                break
            if rec.pad:
                continue
            if rec.state < COMPLETED:
                # reserved but not yet completed: its header has not been
                # written (PR 4 removed the provisional flags=0 header),
                # so the ring holds stale bytes there — skip by state
                continue
            roff = rec.off - self.ring_off
            _, size, crc, flags = unpack_from(buf, roff)
            if not (flags & FLAG_VALID) or (flags & FLAG_CLEANED):
                continue
            live.append((lsn, roff, lsn, size, crc, flags))
        # ordinals here are the LSNs themselves (ascending, unique), so
        # the smallest failing ordinal IS the corrupt record's LSN
        bad = _first_bad_payload(raw, live, self.device)
        if bad is not None:
            raise CorruptLogError(
                f"record {bad}: payload checksum mismatch after recovery")
        mv = memoryview(buf)
        for lsn, roff, _, size, crc, flags in live:
            yield lsn, bytes(mv[roff + REC_HDR_SIZE:roff + REC_HDR_SIZE + size])

    begin = iter_records   # Table-2 naming

    # -- stats ------------------------------------------------------------ #
    def stats(self) -> dict:
        with self._commit_cv:
            return dict(next_lsn=self._next_lsn, head_lsn=self._head_lsn,
                        durable_lsn=self._durable_lsn,
                        complete_upto=self._complete_upto, used=self._used,
                        trim_lsn=self._trim_lsn,
                        free_bytes=self.cfg.capacity - self._used,
                        trimmed_records=self.trimmed_records_total,
                        trimmed_bytes=self.trimmed_bytes_total,
                        space_low_triggers=self.space_low_triggers,
                        full_reclaims=self.full_reclaims,
                        epoch=self._epoch, capacity=self.cfg.capacity,
                        inflight_rounds=len(self._inflight),
                        deferred_errors=len(self._pipe_errors),
                        issue_lsn=self._issue_lsn,
                        pipeline_depth=self._depth,
                        salvage_pending=len(self._salvage),
                        salvage_rounds=self.salvage_rounds_total,
                        reissue_bytes=self.reissue_bytes_total,
                        full_reissue_bytes=self.full_reissue_bytes_total,
                        salvage_stash_bytes=sum(
                            st.total for seg in self._salvage
                            for _, st in seg.salv.pending if st is not None),
                        salvage_stash_cap=self.cfg.salvage_stash_cap,
                        salvage_spilled_bytes=self.salvage_spilled_bytes,
                        salvage_spilled_images=self.salvage_spilled_images,
                        depth_bdp=self._ack_est.bdp_rounds(),
                        force_vns_total=self.force_vns_total,
                        durable_vtime=self._durable_vtime)
