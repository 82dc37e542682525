"""Self-healing replica lifecycle (DESIGN.md §11).

A log that is fast and crash-safe at a point in time still rots over
months of operation: media bits flip under the committed prefix, backups
die and come back hours later, a primary silently stalls.  This module
closes the loop with three cooperating pieces, all deterministic and
unit-testable:

  * ``Scrubber`` — background integrity scan of the committed ring
    prefix on the primary and every live backup, reusing the recovery
    path's batched CRC32/PHASH validation (`log._first_bad_payload`)
    and repairing from any clean quorum copy with the chunk-diff
    machinery (`recovery._diff_ranges`) so only the damaged cache-line
    chunks travel.  A per-pass bandwidth budget (bytes and modelled
    vns) plus a busy-backoff signal keep scrubbing from starving the
    force pipeline; a resume cursor makes budgeted passes cover the
    whole prefix round-robin.

  * ``resync_backup`` — online rejoin for a backup with a long gap
    (§4.2 backup rejoin, carried ROADMAP item): a catch-up phase
    chunk-diffs the *sealed* durable prefix against the returning
    node while the log stays live, then a brief cut-over under the
    log's ``_issue_lock`` streams the issued-but-unsealed delta and
    reopens the lane — no doorbell can post mid-cut-over, so the lane
    rejoins the FIFO order with no gap and no double-send.

  * ``FailureDetector`` — heartbeat-driven failover: periodic
    transport pings, N consecutive misses declare the node down
    (``ClusterManager.report_failure`` → epoch fence + election),
    down nodes are re-probed on exponential backoff with
    deterministic jitter, and a successful probe re-integrates the
    node (on_up hooks run resync FIRST, then
    ``ClusterManager.report_recovery`` restores the write quorum).
    Pairs with the cluster manager's degraded-quorum mode
    (``ClusterManager.attach_group``), which — when policy allows —
    lowers the effective W instead of wedging writes while a quorum
    of copies is unreachable.

``HealthMonitor`` bundles the three over one ``ReplicaSet`` with a
single deterministic ``tick()`` (what the chaos soak drives) or real
background threads (``start``/``stop``).

In this package the copies' images are read as CPU uint8 tensors, once
per copy per pass, and the payload hashes run on the log's ``device``:
one lane matrix and one hash launch per copy per pass, plus one one-row
launch per repaired FLAG_PHASH record.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .log import (FLAG_CLEANED, FLAG_PAD, FLAG_PHASH, FLAG_VALID,
                  REC_HDR_SIZE, _REC_HDR, _SEED, _first_bad_payload,
                  _phash_mismatch, crc32, ring_offset)
from .pmem import PMEMDevice
from .recovery import REPAIR_CHUNK, _diff_ranges

# the record header as a numpy record: lsn, size, crc, flags (``_REC_HDR``)
_HDR_DTYPE = np.dtype([("lsn", "<u8"), ("size", "<u4"), ("crc", "<u4"),
                       ("flags", "<u8")])


def _payload_failures(snap: np.ndarray, ords: np.ndarray, pos: np.ndarray,
                      lsns: np.ndarray, sizes: np.ndarray, crcs: np.ndarray,
                      flags: np.ndarray, device: torch.device) -> np.ndarray:
    """Every failing ordinal among the given records of one image, in one
    validation pass: CRC32 records one by one on the host, FLAG_PHASH
    records in one lane matrix hashed in one launch on ``device``.
    Arrays hold one entry per record (``pos`` = header offset in
    ``snap``).  Returns the failing ordinals, ascending."""
    phash = (flags & FLAG_PHASH) != 0
    bad = []
    mv = memoryview(snap)
    for i, p, lsn, size, crc in zip(
            ords[~phash].tolist(), pos[~phash].tolist(),
            lsns[~phash].tolist(), sizes[~phash].tolist(),
            crcs[~phash].tolist()):
        p0 = p + REC_HDR_SIZE
        if crc32(mv[p0:p0 + size], crc32(_SEED.pack(lsn, size))) != crc:
            bad.append(i)
    if phash.any():
        miss = _phash_mismatch(snap, pos[phash], lsns[phash], sizes[phash],
                               crcs[phash], device)
        bad.extend(ords[phash][miss].tolist())
    return np.sort(np.asarray(bad, dtype=np.int64))


def _runs(offs: np.ndarray, extents: np.ndarray):
    """The byte runs [start, end) that records at ``offs`` of ``extents``
    bytes cover, adjacent records merged, in ascending order; and each
    record's position in the runs laid end to end."""
    order = np.argsort(offs, kind="stable")
    o_off, o_end = offs[order], offs[order] + extents[order]
    cut = np.flatnonzero(o_off[1:] != o_end[:-1]) + 1
    first = np.concatenate([[0], cut])
    last = np.concatenate([cut, [offs.size]]) - 1
    starts, ends = o_off[first], o_end[last]
    base = np.concatenate([[0], np.cumsum(ends - starts)[:-1]])
    run = np.searchsorted(starts, offs, side="right") - 1
    return (list(zip(starts.tolist(), ends.tolist())),
            base[run] + offs - starts[run])


def _bad_ordinals(raw: torch.Tensor, items, device: torch.device) -> set:
    """ALL failing ordinals of the batched payload validator.

    ``items`` as for ``log._first_bad_payload``: (ordinal, ring_pos, lsn,
    size, crc, flags), ``raw`` the CPU uint8 image they lie in.  The JAX
    package re-runs its first-failure validator past each hit (one pass
    per bad record); the set of every failing item is the same, so here
    it comes from one pass (one hash launch on ``device``)."""
    items = list(items)
    if not items:
        return set()
    cols = [np.array([it[k] for it in items], dtype=np.int64)
            for k in range(6)]
    return set(_payload_failures(raw.numpy(), *cols, device).tolist())


# --------------------------------------------------------------------------- #
# background scrubber
# --------------------------------------------------------------------------- #

@dataclass
class ScrubConfig:
    chunk: int = REPAIR_CHUNK          # repair granularity (cache-line mult.)
    max_bytes_per_pass: Optional[int] = None   # scan budget across copies
    max_vns_per_pass: Optional[float] = None   # modelled-time budget
    interval_s: float = 0.02           # thread-mode pass period
    defer_when_busy: bool = True       # skip a pass while the engine is hot


@dataclass
class ScrubReport:
    """One ``scrub_once`` pass."""
    pass_index: int = 0
    deferred: bool = False             # pass skipped (engine busy)
    complete: bool = False             # whole committed prefix covered
    scanned_records: int = 0           # record×copy validations
    scanned_bytes: int = 0             # bytes read across all copies
    corrupt: int = 0                   # record×copy failures found
    repaired: int = 0                  # record×copy failures fixed
    unrepairable: int = 0              # no clean donor copy existed
    skipped_trimmed: int = 0           # repairs dropped: record trimmed
                                       # between snapshot and repair
    repair_bytes: int = 0              # chunk-diff traffic shipped
    repair_ranges: int = 0
    vns: float = 0.0                   # scan_vns + repair_vns (compat)
    scan_vns: float = 0.0              # modelled read+checksum time
    repair_vns: float = 0.0            # modelled repair-traffic time
    corrupt_records: List[Tuple[str, int]] = field(default_factory=list)
    total_records: int = 0             # committed records in the snapshot


class Scrubber:
    """Continuous integrity scan + quorum repair of the committed prefix.

    ``copies`` maps replica name → device holding a full log image (the
    node-local scrub agent's view of its own media).  Detection reads and
    checksums are local to each node; repair ships only the differing
    chunks of a clean donor copy over the repair channel, charged at RDMA
    rates in ``vns``.  Built over a ``ReplicaSet`` via
    :meth:`from_replica_set`, the copy set tracks lane liveness so dead
    backups are neither scanned nor used as donors.
    """

    def __init__(self, log, copies: Optional[Dict[str, PMEMDevice]] = None,
                 cfg: Optional[ScrubConfig] = None,
                 load_signal: Optional[Callable[[], bool]] = None,
                 replica_set=None):
        self.log = log
        self.cfg = cfg or ScrubConfig()
        self._static_copies = dict(copies) if copies else None
        self._rs = replica_set
        self._load_signal = load_signal
        self._cursor = 0               # next LSN to scan (budget resume)
        self._passes = 0
        self._lock = threading.Lock()  # serialize concurrent scrub_once
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        # lifetime totals
        self.passes_total = 0
        self.deferred_total = 0
        self.scanned_bytes_total = 0
        self.corrupt_total = 0
        self.repaired_total = 0
        self.unrepairable_total = 0
        self.skipped_trimmed_total = 0
        self.repair_bytes_total = 0
        self.vns_total = 0.0           # scan + repair (compat)
        self.scan_vns_total = 0.0
        self.repair_vns_total = 0.0

    # -- construction ------------------------------------------------------ #
    @classmethod
    def from_replica_set(cls, rs, cfg: Optional[ScrubConfig] = None,
                         ) -> "Scrubber":
        """Scrub every durable copy of ``rs``: the primary image (when
        local_durable) plus each backup whose lane is still attached.
        Defers to the ingestion engine / force pipeline via the built-in
        busy signal."""
        def busy() -> bool:
            if rs.ingest is not None and rs.ingest.busy:
                return True
            return not rs.log.pipeline_free
        return cls(rs.log, cfg=cfg, load_signal=busy, replica_set=rs)

    def _copies(self) -> Dict[str, PMEMDevice]:
        if self._rs is not None:
            out: Dict[str, PMEMDevice] = {}
            if self._rs.cfg.local_durable:
                out[self._rs.primary_id] = self._rs.primary_dev
            for t in self._rs.transports:
                if not t.closed and not t.failure.drop:
                    out[t.server.server_id] = t.server.device
            return out
        return dict(self._static_copies or {})

    def _busy(self) -> bool:
        if not self.cfg.defer_when_busy:
            return False
        if self._load_signal is not None:
            try:
                return bool(self._load_signal())
            except Exception:
                return False
        return False

    # -- one pass ---------------------------------------------------------- #
    def scrub_once(self, force: bool = False) -> ScrubReport:
        """Scan (a budgeted slice of) the committed prefix on every live
        copy; repair what fails validation from any clean donor copy.
        ``force=True`` ignores the busy signal (the drive-to-clean loops
        in tests and ``scrub_to_completion``)."""
        with self._lock:
            return self._scrub_once_locked(force)

    def _scrub_once_locked(self, force: bool) -> ScrubReport:
        log = self.log
        rep = ScrubReport(pass_index=self._passes)
        self._passes += 1
        self.passes_total += 1
        if not force and self._busy():
            rep.deferred = True
            self.deferred_total += 1
            return rep
        copies = self._copies()
        if not copies:
            rep.complete = True
            return rep
        cost = log.dev.cost
        # snapshot the committed record map: lock order matches cleanup
        # (_alloc_lock outer, _commit_cv inner).  Committed == lsn <=
        # durable_lsn: the covering round met its write quorum, so a
        # clean copy exists somewhere by definition.  Only the C-speed
        # dict copy happens under the locks — filtering and sorting a
        # large prefix here would stall the hot append path.
        with log._alloc_lock:
            with log._commit_cv:
                durable = log._durable_lsn
                head = log._head_lsn
                snap = list(log._recs.values())
        recs = sorted((r.lsn, r.off, r.size, r.extent) for r in snap
                      if head <= r.lsn <= durable and not r.pad)
        if not recs:
            rep.complete = True
            return rep
        rep.total_records = len(recs)
        # round-robin resume: start at the budget cursor
        i0 = 0
        for i, (lsn, _, _, _) in enumerate(recs):
            if lsn >= self._cursor:
                i0 = i
                break
        order = recs[i0:] + recs[:i0]
        budget_b = self.cfg.max_bytes_per_pass
        budget_v = self.cfg.max_vns_per_pass
        n_copies = len(copies)
        scanned: List[Tuple[int, int, int, int]] = []
        for rec in order:
            extent = rec[3]
            if scanned and (
                    (budget_b is not None
                     and rep.scanned_bytes + extent * n_copies > budget_b)
                    or (budget_v is not None
                        and rep.scan_vns >= budget_v)):
                break
            scanned.append(rec)
            rep.scanned_bytes += extent * n_copies
            # the vns budget bounds the SCAN slice: repair traffic is
            # corrective work a corrupt pass must finish regardless, and
            # counting it against the budget used to shrink coverage of
            # exactly the passes that found damage
            rep.scan_vns += extent * n_copies \
                * (cost.pmem_read_byte_ns + cost.crc_byte_ns)
        rep.complete = len(scanned) == len(recs)
        self._cursor = 1 if rep.complete else \
            (scanned[-1][0] + 1 if scanned else self._cursor)
        # per copy: one read of each run of adjacent scanned records (one
        # run, or two where the ring wraps), one batched validation pass.
        # Headers are cross-checked against the authoritative record map
        # first — a corrupted header cannot be trusted to describe its own
        # payload.
        s_lsn, s_off, s_size, s_ext = \
            np.array(scanned, dtype=np.int64).reshape(-1, 4).T
        runs, rel = _runs(s_off, s_ext)
        ords = np.arange(len(scanned), dtype=np.int64)
        images: Dict[str, torch.Tensor] = {}
        corrupt: List[Tuple[str, int]] = []   # (copy name, scan ordinal)
        for name, dev in copies.items():
            parts = [dev.read_tensor(a, b - a) for a, b in runs]
            raw = parts[0] if len(parts) == 1 else torch.cat(parts)
            images[name] = raw
            snap = raw.numpy()
            hdr = np.lib.stride_tricks.sliding_window_view(
                snap, REC_HDR_SIZE)[rel].view(_HDR_DTYPE)[:, 0]
            hl = hdr["lsn"].astype(np.int64)
            hs = hdr["size"].astype(np.int64)
            hf = hdr["flags"].astype(np.int64)
            same = (hl == s_lsn) & (hs == s_size)
            # a tombstone clears FLAG_VALID by design: payload is dead bytes
            tomb = same & ((hf & FLAG_CLEANED) != 0)
            bad_hdr = ~tomb & (~same | ((hf & FLAG_VALID) == 0)
                               | ((hf & FLAG_PAD) != 0))
            corrupt.extend((name, i) for i in ords[bad_hdr].tolist())
            ok = ~tomb & ~bad_hdr
            if ok.any():
                fails = _payload_failures(
                    snap, ords[ok], rel[ok], s_lsn[ok], s_size[ok],
                    hdr["crc"][ok].astype(np.int64), hf[ok], log.device)
                corrupt.extend((name, i) for i in fails.tolist())
        rep.scanned_records = len(scanned) * n_copies
        rep.corrupt = len(corrupt)
        rep.corrupt_records = [(name, scanned[i][0]) for name, i in corrupt]
        # repair: ship only the differing chunks of a clean donor copy
        bad_by_ord: Dict[int, List[str]] = {}
        for name, i in corrupt:
            bad_by_ord.setdefault(i, []).append(name)
        for i, names in sorted(bad_by_ord.items()):
            lsn, off, size, extent = scanned[i]
            # trim race (DESIGN.md §13): the snapshot may predate a bulk
            # truncate, and the reclaimed ring bytes may already hold NEW
            # records — a stale donor image must never overwrite them.
            # Re-check the live head and do the writes under _alloc_lock,
            # which trim holds across its whole head-advance, so the
            # check cannot go stale mid-repair.
            with log._alloc_lock:
                if lsn < log._head_lsn:
                    rep.skipped_trimmed += len(names)
                    self.skipped_trimmed_total += len(names)
                    continue
                donor = next((n for n in copies if n not in names), None)
                if donor is None:
                    rep.unrepairable += len(names)
                    continue
                r0 = int(rel[i])
                golden = images[donor][r0:r0 + extent]
                for name in names:
                    cur = images[name][r0:r0 + extent]
                    dev = copies[name]
                    for a, b in _diff_ranges(golden, cur, off,
                                             chunk=self.cfg.chunk):
                        dev.write(a, golden[a - off:b - off].numpy())
                        dev.persist(a, b - a)
                        rep.repair_bytes += b - a
                        rep.repair_ranges += 1
                        rep.repair_vns += cost.rdma_rtt_ns \
                            + (b - a) * cost.rdma_byte_ns
                    # read back and re-validate before declaring it fixed
                    raw = dev.read_tensor(off, extent)
                    hl, hs, hc, hf = _REC_HDR.unpack_from(raw.numpy(), 0)
                    ok = hl == lsn and hs == size \
                        and bool(hf & (FLAG_VALID | FLAG_CLEANED))
                    if ok and not hf & FLAG_CLEANED:
                        ok = _first_bad_payload(
                            raw, [(0, 0, lsn, size, hc, hf)],
                            log.device) is None
                    if ok:
                        rep.repaired += 1
                    else:
                        rep.unrepairable += 1
        rep.vns = rep.scan_vns + rep.repair_vns
        self.scanned_bytes_total += rep.scanned_bytes
        self.corrupt_total += rep.corrupt
        self.repaired_total += rep.repaired
        self.unrepairable_total += rep.unrepairable
        self.repair_bytes_total += rep.repair_bytes
        self.scan_vns_total += rep.scan_vns
        self.repair_vns_total += rep.repair_vns
        self.vns_total += rep.vns
        # background work rides the log's virtual timeline on its own
        # resource: scan reads occupy scrub bandwidth, repair traffic is
        # wire latency on top (DESIGN.md §14)
        tl = getattr(log, "timeline", None)
        if tl is not None and rep.vns:
            tl.schedule("scrub", busy=rep.scan_vns, latency=rep.repair_vns)
        return rep

    def scrub_to_completion(self, max_passes: int = 64) -> List[ScrubReport]:
        """Drive budgeted passes until a full clean cycle over the
        committed prefix (the quiesced-verify loop the soak harness and
        tests use).  Under a per-pass budget no single pass is complete;
        the round-robin cursor tiles the prefix across passes, so
        consecutive clean passes covering ``total_records`` records
        between them prove a clean cycle."""
        reports: List[ScrubReport] = []
        clean_streak = 0
        for _ in range(max_passes):
            rep = self.scrub_once(force=True)
            reports.append(rep)
            if rep.corrupt:
                clean_streak = 0
                continue
            clean_streak += rep.scanned_records
            n_copies = max(1, len(self._copies()))
            if rep.complete or clean_streak >= rep.total_records * n_copies:
                return reports
        raise RuntimeError(
            f"scrub did not converge in {max_passes} passes "
            f"(last: corrupt={reports[-1].corrupt}, "
            f"unrepairable={reports[-1].unrepairable})")

    # -- thread mode ------------------------------------------------------- #
    def start(self, interval_s: Optional[float] = None) -> None:
        if self._thread is not None:
            return
        period = self.cfg.interval_s if interval_s is None else interval_s
        self._stop_evt.clear()

        def loop() -> None:
            while not self._stop_evt.wait(period):
                try:
                    self.scrub_once()
                except Exception:
                    pass      # a busy/teardown race never kills the loop

        self._thread = threading.Thread(target=loop, name="scrubber",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop_evt.set()
        self._thread.join(timeout=5.0)
        self._thread = None

    def stats(self) -> dict:
        return dict(passes=self.passes_total,
                    deferred=self.deferred_total,
                    scanned_bytes=self.scanned_bytes_total,
                    corrupt_found=self.corrupt_total,
                    repaired=self.repaired_total,
                    unrepairable=self.unrepairable_total,
                    skipped_trimmed=self.skipped_trimmed_total,
                    repair_bytes=self.repair_bytes_total,
                    scrub_vns=self.vns_total,
                    scan_vns=self.scan_vns_total,
                    repair_vns=self.repair_vns_total)


# --------------------------------------------------------------------------- #
# online backup resync
# --------------------------------------------------------------------------- #

@dataclass
class ResyncReport:
    """Traffic accounting for one online backup rejoin."""
    server_id: str
    sealed_bytes: int = 0      # catch-up region size (full re-send cost)
    catchup_bytes: int = 0     # differing chunks actually shipped
    catchup_ranges: int = 0
    cutover_bytes: int = 0     # issued-but-unsealed delta under _issue_lock
    vns: float = 0.0

    @property
    def repair_bytes(self) -> int:
        return self.catchup_bytes + self.cutover_bytes


def resync_backup(rs, server_id: str,
                  chunk: int = REPAIR_CHUNK) -> ResyncReport:
    """Online rejoin (§4.2 backup rejoin, DESIGN.md §11): close a
    returning backup's gap chunk-diff-style while the log stays live.

    Phase 0 — quiesce the lane: settle in-flight group ops so a late
    TransportError from before the failure cannot re-evict the backup
    after the cut-over, and keep the lane CLOSED through catch-up so
    live rounds skip it (their ranges are what the cut-over covers).

    Phase 1 — catch-up, out of band: snapshot the durable watermark (the
    *seal*), then chunk-diff the superline region and the sealed
    committed ring prefix against the backup, shipping only differing
    cache-line-aligned chunks.  Everything at or below the seal is
    immutable on the primary image (records are device-written before
    their round posts and durable ranges never mutate), so the diff races
    nothing; appends continue throughout.

    Phase 2 — cut-over, under ``log._issue_lock``: doorbell posts
    serialize on that lock, so while it is held no new round can reach
    any lane.  Stream the delta the closed lane missed — ``[seal,
    current issue watermark)``, every byte of which is already on the
    primary device — then reopen the transport and unfence this path's
    primary.  The next round a leader posts starts exactly at the issue
    watermark: the rejoined lane sees no gap and nothing is sent twice.
    A pending salvage stash needs no special casing: the stash chain
    begins at the (rolled-back) issue watermark, so its re-issue covers
    the reopened lane like any other live lane.
    """
    log = rs.log
    t = next(tr for tr in rs.transports
             if tr.server.server_id == server_id)
    srv = t.server
    backup = srv.device
    cost = backup.cost
    rep = ResyncReport(server_id=server_id)
    # phase 0: quiesce + detach
    if rs.group is not None:
        rs.group.drain(surface_errors=False)
    t.close()
    # phase 1: catch-up over the sealed prefix (log stays live)
    with log._commit_cv:
        seal_off = log._durable_off
        head_off = log._head_off
    base = ring_offset()
    segs = [(0, base)] + log._range_segs(head_off, seal_off)
    for off, n in segs:
        golden = log.dev.read_tensor(off, n)
        cur = backup.read_tensor(off, n)
        rep.sealed_bytes += n
        rep.vns += 2 * n * cost.pmem_read_byte_ns
        if torch.equal(golden, cur):
            continue
        for a, b in _diff_ranges(golden, cur, off, chunk=chunk):
            backup.write(a, golden[a - off:b - off].numpy())
            backup.persist(a, b - a)
            rep.catchup_bytes += b - a
            rep.catchup_ranges += 1
            rep.vns += cost.rdma_rtt_ns + (b - a) * cost.rdma_byte_ns
    # phase 2: cut-over under the doorbell lock
    with log._issue_lock:
        with log._commit_cv:
            issue_off = log._issue_off
        for off, n in log._range_segs(seal_off, issue_off):
            data = log.dev.read_tensor(off, n)
            backup.write(off, data.numpy())
            backup.persist(off, n)
            rep.cutover_bytes += n
            rep.vns += cost.rdma_rtt_ns + n * cost.rdma_byte_ns
        # a trim during catch-up advanced the watermark slot and
        # superline while this lane was closed; Log.trim holds
        # _issue_lock for its whole body, so re-diffing the meta
        # region here cannot race another advance (DESIGN.md §13).
        # chunk-diff keeps the common no-trim case at zero bytes.
        meta_gold = log.dev.read_tensor(0, base)
        meta_cur = backup.read_tensor(0, base)
        if not torch.equal(meta_gold, meta_cur):
            for a, b in _diff_ranges(meta_gold, meta_cur, 0, chunk=chunk):
                backup.write(a, meta_gold[a:b].numpy())
                backup.persist(a, b - a)
                rep.cutover_bytes += b - a
                rep.vns += cost.rdma_rtt_ns + (b - a) * cost.rdma_byte_ns
        t.reopen()
        # re-admit only THIS path's primary: a ClusterManager epoch
        # fence of a deposed primary must stay up
        srv.unfence(t.primary_id)
    return rep


# --------------------------------------------------------------------------- #
# heartbeat failure detector
# --------------------------------------------------------------------------- #

@dataclass
class HeartbeatConfig:
    interval_s: float = 0.02           # probe period for healthy nodes
    miss_threshold: int = 3            # consecutive misses => down
    backoff_base_s: float = 0.05       # first re-probe delay for a down node
    backoff_max_s: float = 1.0
    jitter: float = 0.25               # +- fraction on every delay
    seed: int = 0                      # deterministic jitter stream


@dataclass
class _ProbeState:
    next_due: float = 0.0
    misses: int = 0
    down: bool = False
    backoff_s: float = 0.0


class FailureDetector:
    """Heartbeat probes + automated failover/rejoin over a ClusterManager.

    Healthy nodes are probed every ``interval_s``; ``miss_threshold``
    consecutive failures declare the node down — the cluster manager
    fences/elects (and reviews degraded quorum) via ``report_failure``,
    then ``on_down`` hooks fire.  Down nodes are re-probed on exponential
    backoff with deterministic jitter; a successful probe runs the
    ``on_up`` hooks FIRST (the resync path — the node must hold the full
    prefix before it counts toward quorum again) and only then calls
    ``report_recovery``, which restores the configured write quorum.  A
    failing on_up hook leaves the node down for the next backoff tick.

    ``tick(now)`` is the deterministic core (the soak harness advances a
    virtual clock); ``start``/``stop`` wrap it in a wall-clock thread.
    """

    def __init__(self, cluster, cfg: Optional[HeartbeatConfig] = None):
        self.cluster = cluster
        self.cfg = cfg or HeartbeatConfig()
        self._rng = random.Random(self.cfg.seed)
        self._probes: Dict[str, Callable[[], object]] = {}
        self._state: Dict[str, _ProbeState] = {}
        self._on_down: List[Callable[[str], None]] = []
        self._on_up: List[Callable[[str], None]] = []
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self.probes_sent = 0
        self.probes_failed = 0
        self.down_events = 0
        self.up_events = 0

    # -- registration ------------------------------------------------------ #
    def register(self, node_id: str,
                 probe: Callable[[], object]) -> None:
        """``probe`` raises (any exception) on an unreachable node."""
        self._probes[node_id] = probe
        self._state[node_id] = _ProbeState()

    def register_transport(self, t) -> None:
        """Probe a backup through its transport's heartbeat verb."""
        self.register(t.server.server_id, t.ping)

    def on_down(self, cb: Callable[[str], None]) -> None:
        self._on_down.append(cb)

    def on_up(self, cb: Callable[[str], None]) -> None:
        self._on_up.append(cb)

    # -- deterministic core ------------------------------------------------ #
    def _jittered(self, delay: float) -> float:
        return delay * (1.0 + self.cfg.jitter * (2 * self._rng.random() - 1))

    def tick(self, now: float) -> List[Tuple[str, str]]:
        """Probe every node whose next_due has passed; returns the
        membership transitions [('down'|'up', node_id), ...] this tick."""
        events: List[Tuple[str, str]] = []
        with self._lock:
            for nid, probe in self._probes.items():
                st = self._state[nid]
                if now < st.next_due:
                    continue
                self.probes_sent += 1
                try:
                    probe()
                    ok = True
                except Exception:
                    ok = False
                    self.probes_failed += 1
                if ok and not st.down:
                    st.misses = 0
                    st.next_due = now + self._jittered(self.cfg.interval_s)
                elif not ok and not st.down:
                    st.misses += 1
                    if st.misses >= self.cfg.miss_threshold:
                        st.down = True
                        st.backoff_s = self.cfg.backoff_base_s
                        st.next_due = now + self._jittered(st.backoff_s)
                        self.down_events += 1
                        events.append(("down", nid))
                        self.cluster.report_failure(nid)
                        for cb in self._on_down:
                            cb(nid)
                    else:
                        st.next_due = now \
                            + self._jittered(self.cfg.interval_s)
                elif not ok:     # still down: exponential backoff
                    st.backoff_s = min(st.backoff_s * 2,
                                       self.cfg.backoff_max_s)
                    st.next_due = now + self._jittered(st.backoff_s)
                else:            # down node answered: re-integrate
                    try:
                        for cb in self._on_up:
                            cb(nid)
                    except Exception:
                        # resync failed: stay down, retry next backoff
                        st.backoff_s = min(st.backoff_s * 2,
                                           self.cfg.backoff_max_s)
                        st.next_due = now + self._jittered(st.backoff_s)
                        continue
                    st.down = False
                    st.misses = 0
                    st.backoff_s = 0.0
                    st.next_due = now + self._jittered(self.cfg.interval_s)
                    self.up_events += 1
                    events.append(("up", nid))
                    self.cluster.report_recovery(nid)
        return events

    # -- thread mode ------------------------------------------------------- #
    def start(self) -> None:
        if self._thread is not None:
            return

        def loop() -> None:
            period = max(self.cfg.interval_s / 2, 1e-3)
            while not self._stop_evt.wait(period):
                try:
                    self.tick(time.monotonic())
                except Exception:
                    pass

        self._stop_evt.clear()
        self._thread = threading.Thread(target=loop, name="heartbeat",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop_evt.set()
        self._thread.join(timeout=5.0)
        self._thread = None

    def stats(self) -> dict:
        return dict(probes_sent=self.probes_sent,
                    probes_failed=self.probes_failed,
                    down_events=self.down_events,
                    up_events=self.up_events,
                    down_nodes=sorted(n for n, s in self._state.items()
                                      if s.down))


# --------------------------------------------------------------------------- #
# one-stop lifecycle bundle
# --------------------------------------------------------------------------- #

class HealthMonitor:
    """Scrubber + failure detector + auto-resync over one ``ReplicaSet``.

    Wiring: each backup transport is heartbeat-probed; a down verdict
    runs ``cluster.report_failure`` (fence/elect/degrade); a node that
    answers again is resynced through :func:`resync_backup` (gap closed
    chunk-diff-style) and only then counted back toward quorum.  The
    scrubber covers every live copy under its bandwidth budget.

    ``tick(now)`` drives both deterministically; ``start``/``stop`` run
    them on background threads.  Built by ``ReplicaSet.attach_health``.
    """

    def __init__(self, rs, cluster=None,
                 scrub: Optional[ScrubConfig] = None,
                 heartbeat: Optional[HeartbeatConfig] = None,
                 allow_degraded: bool = False,
                 min_write_quorum: int = 1):
        from .cluster import ClusterManager, Node   # avoid import cycle
        self.rs = rs
        if cluster is None:
            nodes = [Node(rs.primary_id, server=None)] + \
                [Node(s.server_id, server=s) for s in rs.servers]
            cluster = ClusterManager(nodes)
        # the manager must settle THIS log's force pipeline before any
        # failover re-wiring — also when the caller brought its own
        # cluster (the shard router hands each shard a named manager)
        if rs.log is not None and rs.log not in cluster._logs:
            cluster.attach_log(rs.log)
        self.cluster = cluster
        if rs.group is not None:
            self.cluster.attach_group(rs.group,
                                      allow_degraded=allow_degraded,
                                      min_write_quorum=min_write_quorum)
        self.scrubber = Scrubber.from_replica_set(rs, cfg=scrub)
        self.detector = FailureDetector(self.cluster, cfg=heartbeat)
        for t in rs.transports:
            self.detector.register_transport(t)
        self.detector.on_up(lambda nid: rs.recover_backup(nid))
        self._scrub_due = 0.0

    def tick(self, now: float) -> List[Tuple[str, str]]:
        events = self.detector.tick(now)
        if now >= self._scrub_due:
            self.scrubber.scrub_once()
            self._scrub_due = now + self.scrubber.cfg.interval_s
        return events

    def start(self) -> None:
        self.scrubber.start()
        self.detector.start()

    def stop(self) -> None:
        self.detector.stop()
        self.scrubber.stop()

    def stats(self) -> dict:
        return dict(scrub=self.scrubber.stats(),
                    detector=self.detector.stats(),
                    cluster=self.cluster.stats())
