"""Sharded multi-log router (DESIGN.md §12).

One ``Log`` is one ring on one device with one force pipeline; the
router runs N of them side by side, each an independent ``ReplicaSet``
(own PMEM devices, own replica lanes, own pipelined force engine, own
optional group-commit ingest front end), and multiplies throughput the
way the paper's design intends: logs never share an ordering domain, so
K shards run K alloc/commit serializations and K durability pipelines
concurrently.

  Routing    — ``append``/``submit`` hash the caller's key over the
               shard table (CRC32 mod N) or take an explicit shard id;
               a shard's records stay on that shard, so per-shard LSN
               chains are gapless and recovery never merges rings.
  Placement  — ``ShardPlacement`` ports the mesh idiom from
               distributed/sharding.py (priority resolution over a node
               axis): primaries rotate across the node list and a
               shard's backups land on the next distinct nodes
               (anti-affinity), so losing one node costs each shard at
               most one copy.
  Recovery   — ``recover()`` runs the §4.2 quorum protocol over every
               shard's surviving copies concurrently (rings are
               independent, so the scans are embarrassingly parallel)
               and reports per-shard ``RecoveryReport``s plus the
               aggregate; ``parallel=False`` runs the identical
               protocol serially — the record streams must be
               byte-identical (pinned by ci_bench).
  Snapshot   — ``snapshot_cut()`` is a two-phase watermark capture:
               phase one acquires every shard's ``_issue_lock`` in
               fixed shard order (no deadlock: all cutters use the same
               order) so no shard can issue a new durability round
               while any other is being read; phase two records each
               shard's (issue, durable) watermark pair and releases.
               There is a real-time instant — while all locks are held
               — at which the cut vector IS the issued prefix of every
               shard simultaneously, so a view filtered to the cut
               (``cut_records``/``Log.iter_records(upto=...)``) is a
               coherent cross-shard state without quiescing appends.
  Health     — ``attach_health`` gives each shard its own named
               ``ClusterManager`` + ``HealthMonitor``: one shard's
               backup can die, degrade, resync and rejoin while sibling
               shards stay hot, and stats/faults stay shard-isolated.

The router's ``device`` is where every shard's integrity hashing runs:
each shard's log is built on it, and the recovery scans validate on it
(``"cuda"`` by default, where the hash is a CUDA kernel; ``"cpu"`` for
the plain version).
"""

from __future__ import annotations

import threading
import time
import zlib
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from ..device import resolve_device
from .force_policy import ForcePolicy
from .ingest import IngestConfig, IngestEngine, IngestTicket
from .log import Log, LogConfig
from .pmem import CostModel, PMEMDevice
from .recovery import CopyAccessor, RecoveryReport, quorum_recover
from .replication import ReplicaSet, build_replica_set


class RouterError(Exception):
    pass


class UnknownShardError(RouterError):
    pass


# --------------------------------------------------------------------------- #
# placement
# --------------------------------------------------------------------------- #

@dataclass(frozen=True)
class ShardPlacement:
    """Mesh-style shard placement over a 1-D node axis.

    The idiom mirrors ``distributed/sharding.py``'s ShardingRules: a
    fixed axis of resources, a deterministic priority walk, and an
    anti-reuse constraint.  Here the axis is the node list, the walk
    rotates shard primaries ``stride`` nodes apart, and the constraint
    is anti-affinity — a shard's backups take the next distinct nodes
    after its primary, never the primary's own node.  Losing one node
    therefore degrades every shard by at most one copy, and consecutive
    shards never stack their primaries on the same node.
    """

    nodes: Tuple[str, ...] = ("node0", "node1", "node2", "node3")
    stride: int = 1

    def assign(self, index: int, n_backups: int) -> Tuple[str, List[str]]:
        n = len(self.nodes)
        if n_backups >= n:
            raise ValueError(
                f"{n_backups} backups need {n_backups + 1} distinct nodes; "
                f"placement has {n}")
        p = (index * self.stride) % n
        primary = self.nodes[p]
        backups = [self.nodes[(p + 1 + k) % n] for k in range(n_backups)]
        return primary, backups


# --------------------------------------------------------------------------- #
# shard construction
# --------------------------------------------------------------------------- #

@dataclass
class ShardSpec:
    """Per-shard deployment config — the ``build_replica_set`` surface
    plus a shard id.  Shards are heterogeneous on purpose: a tenant can
    run W=3 strict-device shards next to another tenant's local fast
    shards on the same router."""

    shard_id: str
    mode: str = "local"
    capacity: int = 1 << 20
    n_backups: int = 0
    write_quorum: Optional[int] = None
    device_mode: str = "fast"
    cost: Optional[CostModel] = None
    pipeline_depth: int = 1
    adaptive_depth: bool = False
    salvage: bool = True
    ingest: Optional[IngestConfig] = None


@dataclass
class Shard:
    """One routed log: its spec, its replica set, and router-side
    traffic counters (under the router lock; shard-isolated)."""

    spec: ShardSpec
    rs: ReplicaSet
    index: int
    appends: int = 0
    bytes_in: int = 0

    @property
    def shard_id(self) -> str:
        return self.spec.shard_id

    @property
    def log(self) -> Log:
        return self.rs.log

    @property
    def engine(self) -> Optional[IngestEngine]:
        return self.rs.ingest


# --------------------------------------------------------------------------- #
# snapshot cut
# --------------------------------------------------------------------------- #

@dataclass(frozen=True)
class SnapshotCut:
    """A consistent cross-shard watermark vector (DESIGN.md §12).

    ``lsns[sid]`` is the shard's frozen issue watermark — every record a
    force round had been issued for when the cut froze, i.e. everything
    that could possibly have been acked to any client by then.
    ``durable[sid]`` is the durable watermark at the same instant (what
    HAD been acked).  A record acked before the cut began is always
    inside the cut; a record appended after the cut returned is always
    outside it."""

    lsns: Dict[str, int]
    durable: Dict[str, int]
    freeze_s: float               # wall time all locks were held


def payload_digest(payloads: Iterable[bytes]) -> int:
    """Order-independent CRC32 digest of a payload multiset (sorted
    before hashing) — comparable across shard counts and interleavings."""
    d = 0
    for p in sorted(payloads):
        d = zlib.crc32(p, d)
    return d


def stream_digest(records: Iterable[Tuple[int, bytes]]) -> int:
    """Order-SENSITIVE digest of one shard's (lsn, payload) stream —
    byte-identical record streams (same LSNs, same payloads, same
    order) have equal digests."""
    d = 0
    for lsn, p in records:
        d = zlib.crc32(lsn.to_bytes(8, "little"), d)
        d = zlib.crc32(p, d)
    return d


# --------------------------------------------------------------------------- #
# shard-parallel recovery
# --------------------------------------------------------------------------- #

@dataclass
class ShardRecovery:
    shard_id: str
    report: RecoveryReport
    records: int
    digest: int                   # stream_digest of the recovered records
    wall_s: float


@dataclass
class RouterRecovery:
    """Per-shard + aggregate recovery outcome.  ``logs`` are open on
    the recovered per-shard images (inspection/replay; not wired to
    replication)."""

    shards: "OrderedDict[str, ShardRecovery]"
    logs: Dict[str, Log]
    parallel: bool
    wall_s: float

    @property
    def records(self) -> int:
        return sum(sr.records for sr in self.shards.values())

    @property
    def digests(self) -> Dict[str, int]:
        return {sid: sr.digest for sid, sr in self.shards.items()}

    def aggregate(self) -> dict:
        return dict(
            shards=len(self.shards), records=self.records,
            parallel=self.parallel, wall_s=self.wall_s,
            serial_wall_s=sum(sr.wall_s for sr in self.shards.values()),
            repaired={sid: sr.report.repaired
                      for sid, sr in self.shards.items() if sr.report.repaired},
            last_lsns={sid: sr.report.last_lsn
                       for sid, sr in self.shards.items()})


# --------------------------------------------------------------------------- #
# the router
# --------------------------------------------------------------------------- #

class LogRouter:
    """N independent logs behind one append surface (module docstring)."""

    def __init__(self, placement: Optional[ShardPlacement] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.placement = placement or ShardPlacement()
        self._shards: "OrderedDict[str, Shard]" = OrderedDict()
        self._route: List[Shard] = []          # hash table (insertion order)
        self._lock = threading.Lock()          # registry + counters

    # -- registry ---------------------------------------------------------- #
    def add_shard(self, spec: ShardSpec,
                  policy: Optional[ForcePolicy] = None) -> Shard:
        """Build the shard's replica set per spec, with placement-derived
        node names: primary on ``<node>/<shard_id>``, backups on the
        next distinct nodes.  ``policy`` seeds the shard's ingest engine
        (sync by default)."""
        with self._lock:
            if spec.shard_id in self._shards:
                raise RouterError(f"duplicate shard id {spec.shard_id!r}")
            index = len(self._shards)
        primary_node, backup_nodes = self.placement.assign(
            index, spec.n_backups)
        rs = build_replica_set(
            mode=spec.mode, capacity=spec.capacity,
            n_backups=spec.n_backups, write_quorum=spec.write_quorum,
            device_mode=spec.device_mode, cost=spec.cost,
            primary_id=f"{primary_node}/{spec.shard_id}",
            pipeline_depth=spec.pipeline_depth,
            adaptive_depth=spec.adaptive_depth, salvage=spec.salvage,
            backup_ids=[f"{n}/{spec.shard_id}" for n in backup_nodes],
            device=self.device)
        if spec.ingest is not None:
            rs.attach_ingest(cfg=spec.ingest, policy=policy)
        return self._register(spec, rs, index)

    def adopt_shard(self, spec: ShardSpec, rs: ReplicaSet) -> Shard:
        """Register a pre-built replica set as a shard (tests and
        migrations that bring their own devices)."""
        with self._lock:
            if spec.shard_id in self._shards:
                raise RouterError(f"duplicate shard id {spec.shard_id!r}")
            index = len(self._shards)
        return self._register(spec, rs, index)

    def _register(self, spec: ShardSpec, rs: ReplicaSet,
                  index: int) -> Shard:
        sh = Shard(spec=spec, rs=rs, index=index)
        with self._lock:
            self._shards[spec.shard_id] = sh
            self._route.append(sh)
        return sh

    @property
    def shard_ids(self) -> List[str]:
        with self._lock:
            return list(self._shards)

    def shard(self, shard_id: str) -> Shard:
        try:
            return self._shards[shard_id]
        except KeyError:
            raise UnknownShardError(f"no shard {shard_id!r}") from None

    def __len__(self) -> int:
        return len(self._shards)

    # -- routing ----------------------------------------------------------- #
    def shard_for(self, key: bytes) -> Shard:
        if not self._route:
            raise RouterError("router has no shards")
        return self._route[zlib.crc32(key) % len(self._route)]

    def _pick(self, key: Optional[bytes],
              shard_id: Optional[str]) -> Shard:
        if shard_id is not None:
            return self.shard(shard_id)
        if key is None:
            raise RouterError("append/submit needs a key or a shard_id")
        return self.shard_for(key)

    def append(self, data: bytes, key: Optional[bytes] = None,
               shard_id: Optional[str] = None) -> Tuple[str, int]:
        """Scalar durable append (sync force) on the routed shard;
        returns (shard_id, lsn)."""
        sh = self._pick(key, shard_id)
        lsn = sh.rs.log.append(data)
        with self._lock:
            sh.appends += 1
            sh.bytes_in += len(data)
        return sh.shard_id, lsn

    def submit(self, data: bytes, key: Optional[bytes] = None,
               shard_id: Optional[str] = None,
               timeout: Optional[float] = None
               ) -> Tuple[str, IngestTicket]:
        """Group-commit append through the routed shard's ingest engine;
        returns (shard_id, ticket)."""
        sh = self._pick(key, shard_id)
        eng = sh.rs.ingest
        if eng is None:
            raise RouterError(
                f"shard {sh.shard_id!r} has no ingest engine "
                f"(ShardSpec.ingest)")
        t = eng.append(data, timeout=timeout)
        with self._lock:
            sh.appends += 1
            sh.bytes_in += len(data)
        return sh.shard_id, t

    # -- snapshot cut ------------------------------------------------------- #
    def snapshot_cut(self) -> SnapshotCut:
        """Two-phase consistent cut (module docstring).  Lock order is
        registry order — the only order any cutter uses, so concurrent
        cuts cannot deadlock.  Appends keep flowing: only the force
        ISSUE path is briefly excluded, and only for the freeze."""
        with self._lock:
            shards = list(self._shards.values())
        held: List[Shard] = []
        t0 = time.monotonic()
        try:
            for sh in shards:                      # phase 1: freeze
                sh.rs.log._issue_lock.acquire()
                held.append(sh)
            issue: Dict[str, int] = {}
            durable: Dict[str, int] = {}
            for sh in shards:                      # phase 2: record
                i, d = sh.rs.log.capture_watermarks()
                issue[sh.shard_id] = i
                durable[sh.shard_id] = d
        finally:
            for sh in reversed(held):
                sh.rs.log._issue_lock.release()
        return SnapshotCut(lsns=issue, durable=durable,
                           freeze_s=time.monotonic() - t0)

    def wait_cut_durable(self, cut: SnapshotCut,
                         timeout: float = 30.0) -> None:
        """Block until every shard's durable watermark covers the cut.
        The cut froze ISSUE watermarks, so every covered round is
        already in flight and retires on its own (or fails — surfaced
        here as a timeout; the shard's next force/drain raises the
        deferred error itself)."""
        deadline = time.monotonic() + timeout
        for sid, lsn in cut.lsns.items():
            log = self.shard(sid).rs.log
            last = log.durable_lsn
            while last < lsn:
                if time.monotonic() >= deadline:
                    raise RouterError(
                        f"cut not durable within {timeout}s: shard {sid} "
                        f"at {last} < {lsn}")
                last = log.wait_durable_change(last, timeout=0.05)

    def cut_records(self, cut: SnapshotCut
                    ) -> Iterator[Tuple[str, int, bytes]]:
        """Replay the cut view from the LIVE logs: (shard_id, lsn,
        payload) for every record at or below each shard's cut
        watermark.  Within a shard the stream is LSN-ordered (so
        last-writer-wins replays are exact); across shards the cut
        guarantees mutual consistency, not an order."""
        for sid, upto in cut.lsns.items():
            log = self.shard(sid).rs.log
            for lsn, payload in log.iter_records(upto=upto):
                yield sid, lsn, payload

    def cut_digest(self, cut: SnapshotCut) -> int:
        return payload_digest(p for _, _, p in self.cut_records(cut))

    # -- lifecycle: per-shard trim (DESIGN.md §13) --------------------------- #
    def trim_shard(self, shard_id: str, upto_lsn: int) -> float:
        """Bulk-truncate one shard's log up to (and including)
        ``upto_lsn`` via its durable trim watermark; sibling shards are
        untouched.  Returns modelled vns."""
        return self.shard(shard_id).rs.log.trim(upto_lsn)

    def trim_to_cut(self, cut: SnapshotCut) -> Dict[str, float]:
        """Truncate every shard up to its DURABLE watermark in ``cut``.

        The caller must have materialized the cut's view first (e.g.
        ``MultiTenantKV.snapshot_view`` or ``cut_records`` persisted to
        a snapshot) — after this returns, records at or below
        ``cut.durable[sid]`` exist only in that snapshot.  Using the
        durable (not issue) watermark keeps the call trivially legal:
        ``Log.trim`` refuses to pass the shard's durable LSN, and
        durable ≤ issue ≤ the cut view's coverage."""
        out: Dict[str, float] = {}
        for sid, lsn in cut.durable.items():
            log = self.shard(sid).rs.log
            out[sid] = log.trim(min(lsn, log.durable_lsn))
        return out

    # -- shard-parallel recovery -------------------------------------------- #
    def recover(self, parallel: bool = True,
                devices: Optional[Dict[str, Dict[str, PMEMDevice]]] = None,
                ) -> RouterRecovery:
        """Run §4.2 quorum recovery over every shard concurrently.

        Call on a quiesced/shut-down router (or pass ``devices`` —
        per-shard {copy_name: surviving device} images, e.g. crash
        survivors).  Rings are independent, so shard scans share
        nothing and run on one thread each; ``parallel=False`` is the
        serial reference — identical protocol, identical per-shard
        record streams (``ShardRecovery.digest``)."""
        with self._lock:
            shards = list(self._shards.values())

        def one(sh: Shard) -> Tuple[ShardRecovery, Log]:
            t0 = time.perf_counter()
            devs = (devices or {}).get(sh.shard_id) \
                or sh.rs.server_devices()
            accessors = [CopyAccessor.for_device(n, d)
                         for n, d in devs.items()]
            local = sh.rs.primary_id if sh.rs.cfg.local_durable else None
            img, report = quorum_recover(
                accessors, sh.rs.cfg, sh.rs.cfg.write_quorum,
                local_name=local if local in devs else None,
                device=self.device)
            log = Log.open(img, LogConfig(capacity=sh.rs.cfg.capacity),
                           device=self.device)
            recs = list(log.iter_records())
            sr = ShardRecovery(
                shard_id=sh.shard_id, report=report, records=len(recs),
                digest=stream_digest(recs),
                wall_s=time.perf_counter() - t0)
            return sr, log

        t0 = time.perf_counter()
        if parallel and len(shards) > 1:
            with ThreadPoolExecutor(max_workers=len(shards)) as ex:
                results = list(ex.map(one, shards))
        else:
            results = [one(sh) for sh in shards]
        wall = time.perf_counter() - t0
        out: "OrderedDict[str, ShardRecovery]" = OrderedDict()
        logs: Dict[str, Log] = {}
        for sr, log in results:
            out[sr.shard_id] = sr
            logs[sr.shard_id] = log
        return RouterRecovery(shards=out, logs=logs, parallel=parallel,
                              wall_s=wall)

    # -- health / fault injection ------------------------------------------- #
    def attach_health(self, scrub=None, heartbeat=None,
                      allow_degraded: bool = False,
                      min_write_quorum: int = 1) -> Dict[str, object]:
        """Per-shard self-healing (DESIGN.md §11, one bundle per shard):
        each replicated shard gets its own named ClusterManager +
        HealthMonitor, so membership, degraded-quorum state, scrub and
        resync are all shard-isolated.  Local-only shards have no lanes
        to probe and are skipped.  Returns {shard_id: HealthMonitor}."""
        from .cluster import ClusterManager, Node
        out: Dict[str, object] = {}
        with self._lock:
            shards = list(self._shards.values())
        for sh in shards:
            if not sh.rs.servers:
                continue
            if sh.rs.health is None:
                nodes = [Node(sh.rs.primary_id, server=None)] + \
                    [Node(s.server_id, server=s) for s in sh.rs.servers]
                cluster = ClusterManager(nodes, name=sh.shard_id)
                sh.rs.attach_health(
                    cluster=cluster, scrub=scrub, heartbeat=heartbeat,
                    allow_degraded=allow_degraded,
                    min_write_quorum=min_write_quorum)
            out[sh.shard_id] = sh.rs.health
        return out

    def tick_health(self, now: float) -> List[Tuple[str, str, str]]:
        """Deterministic health tick across every shard's monitor;
        returns [(shard_id, 'down'|'up', node_id), ...]."""
        events: List[Tuple[str, str, str]] = []
        with self._lock:
            shards = list(self._shards.values())
        for sh in shards:
            if sh.rs.health is not None:
                for ev, nid in sh.rs.health.tick(now):
                    events.append((sh.shard_id, ev, nid))
        return events

    def fail_backup(self, shard_id: str, server_id: str) -> None:
        """Shard-scoped fault injection: partition one backup of ONE
        shard; sibling shards' lanes are untouched."""
        self.shard(shard_id).rs.fail_backup(server_id)

    def kill_backup_midwire(self, shard_id: str, server_id: str,
                            **kw) -> None:
        self.shard(shard_id).rs.kill_backup_midwire(server_id, **kw)

    # -- lifecycle ---------------------------------------------------------- #
    def drain(self, timeout: float = 30.0) -> None:
        """Settle every shard: ingest queues flushed and acked, force
        pipelines empty.  Raises the FIRST shard failure after draining
        the rest (every shard gets its settle attempt)."""
        first: Optional[BaseException] = None
        with self._lock:
            shards = list(self._shards.values())
        for sh in shards:
            try:
                if sh.rs.ingest is not None:
                    sh.rs.ingest.drain(timeout=timeout)
                sh.rs.log.drain(timeout=timeout)
            except BaseException as exc:
                if first is None:
                    first = exc
        if first is not None:
            raise first

    def shutdown(self) -> None:
        with self._lock:
            shards = list(self._shards.values())
        for sh in shards:
            sh.rs.shutdown()

    # -- observability ------------------------------------------------------ #
    def modelled_makespan_ns(self) -> float:
        """Modelled completion time of the whole shard fleet: shards are
        independent devices and wires, so N-way hardware waits on the
        slowest shard's virtual timeline — a real per-resource timeline
        max (DESIGN.md §14), not the old ``max(force_vns_total)`` serial
        sum that ignored each shard's own pipeline overlap."""
        with self._lock:
            shards = list(self._shards.values())
        return max((sh.rs.log.modelled_time_ns() for sh in shards),
                   default=0.0)

    def stats(self) -> dict:
        with self._lock:
            shards = list(self._shards.values())
        per = OrderedDict()
        totals = dict(appends=0, bytes_in=0, records=0)
        for sh in shards:
            st = dict(router=dict(appends=sh.appends,
                                  bytes_in=sh.bytes_in,
                                  index=sh.index,
                                  primary=sh.rs.primary_id),
                      log=sh.rs.log.stats())
            if sh.rs.ingest is not None:
                st["engine"] = sh.rs.ingest.stats()
            if sh.rs.health is not None:
                st["health"] = sh.rs.health.stats()
            per[sh.shard_id] = st
            totals["appends"] += sh.appends
            totals["bytes_in"] += sh.bytes_in
            totals["records"] += st["log"]["next_lsn"] - 1
        return dict(shards=per, totals=totals,
                    n_shards=len(per),
                    modelled_makespan_ns=max(
                        (sh.rs.log.modelled_time_ns() for sh in shards),
                        default=0.0))
