"""Replica-set construction for the three deployment modes (§4.1).

  local         — one durable copy on local PMEM, no backups.
  local+remote  — local primary copy + one or more remote backups.
  remote_only   — client holds a volatile (DRAM) staging copy; all durable
                  copies are remote (nodes without PMEM can still log).

A ``ReplicaSet`` owns the devices/servers/transports and builds the
``ReplicationGroup`` + ``Log`` wired together; tests and benchmarks use it
as the one-stop fixture, and the cluster manager re-wires it on failover.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .force_policy import ForcePolicy
from .ingest import IngestConfig, IngestEngine
from ..device import resolve_device
from .log import Log, LogConfig, ring_offset
from .pmem import CostModel, PMEMDevice
from .transport import ReplicaServer, ReplicationGroup, Transport

MODES = ("local", "local+remote", "remote_only")


@dataclass
class ReplicaSet:
    mode: str
    cfg: LogConfig
    primary_id: str
    primary_dev: PMEMDevice                  # durable copy or DRAM staging
    servers: List[ReplicaServer] = field(default_factory=list)
    transports: List[Transport] = field(default_factory=list)
    group: Optional[ReplicationGroup] = None
    log: Optional[Log] = None
    ingest: Optional[IngestEngine] = None
    health: Optional[object] = None          # HealthMonitor (DESIGN.md §11)

    @property
    def n_durable(self) -> int:
        return len(self.servers) + (1 if self.cfg.local_durable else 0)

    def server_devices(self) -> Dict[str, PMEMDevice]:
        out = {s.server_id: s.device for s in self.servers}
        if self.cfg.local_durable:
            out[self.primary_id] = self.primary_dev
        return out

    def fail_backup(self, server_id: str) -> None:
        """Partition / kill one backup: its transport starts timing out."""
        for t in self.transports:
            if t.server.server_id == server_id:
                t.inject(drop=True)

    def kill_backup_midwire(self, server_id: str, settle_s: float = 0.02,
                            timeout: float = 10.0) -> None:
        """Deterministic mid-wire backup death for tests and benchmarks:
        wait briefly so acks already on the other lanes land, fence this
        replica set's primary at the backup (its in-flight ops fail on
        the wire), then wait until every in-flight durability round has
        settled.  The shared fault harness behind the salvage scenarios
        — keep the timing dance here, not at call sites."""
        time.sleep(settle_s)
        for srv in self.servers:
            if srv.server_id == server_id:
                srv.fence(self.primary_id)
        if self.log is not None:
            deadline = time.monotonic() + timeout
            while self.log.stats()["inflight_rounds"] \
                    and time.monotonic() < deadline:
                time.sleep(0.002)

    def recover_backup(self, server_id: str, resync: bool = True):
        """Rejoin a recovered backup (§4.2).

        With ``resync=True`` (the default) the gap the backup
        accumulated while dead is closed ONLINE through
        ``health.resync_backup`` (DESIGN.md §11): a catch-up phase
        chunk-diffs the sealed durable prefix while the log stays live,
        then a brief cut-over under the log's issue lock streams the
        issued-but-unsealed delta, reopens the lane and re-admits this
        path's primary (epoch fencing across real failovers stays with
        ClusterManager).  Returns the ``ResyncReport`` with the traffic
        accounting (``repair_bytes`` ≪ a full image re-send).

        ``resync=False`` is the legacy rejoin: settle the lanes, reopen,
        unfence — the backup's device keeps whatever it had, and the
        salvage path (DESIGN.md §9) or quorum repair closes the gap."""
        if resync and self.log is not None:
            from .health import resync_backup
            return resync_backup(self, server_id)
        if self.group is not None:
            self.group.drain(surface_errors=False)
        for t in self.transports:
            if t.server.server_id == server_id:
                t.reopen()
                # re-admit only THIS path's primary: a ClusterManager
                # epoch fence of a deposed primary must stay up
                t.server.unfence(t.primary_id)
        return None

    def trim(self, upto_lsn: int) -> float:
        """Bulk-truncate ``[head, upto_lsn]`` on every copy (DESIGN.md
        §13): the durable trim watermark advances with one 8-byte-atomic
        store, replicated through the normal lane/quorum machinery so a
        rejoining backup resyncs only the surviving suffix.  Delegates
        to ``Log.trim``; returns modelled vns."""
        return self.log.trim(upto_lsn)

    def attach_health(self, cluster=None, scrub=None, heartbeat=None,
                      allow_degraded: bool = False,
                      min_write_quorum: int = 1):
        """Build (once) the self-healing lifecycle bundle (DESIGN.md
        §11): background scrubber over every durable copy, heartbeat
        failure detector over the backup lanes, automatic resync +
        quorum restore on rejoin.  ``shutdown()`` stops it."""
        if self.health is None:
            from .health import HealthMonitor
            self.health = HealthMonitor(
                self, cluster=cluster, scrub=scrub, heartbeat=heartbeat,
                allow_degraded=allow_degraded,
                min_write_quorum=min_write_quorum)
        return self.health

    def attach_ingest(self, cfg: Optional[IngestConfig] = None,
                      policy: Optional[ForcePolicy] = None) -> IngestEngine:
        """Build (once) the group-commit ingestion front end (DESIGN.md
        §10) over this set's log.  shutdown() closes it before tearing
        down the lanes so producers never hang on a dead replica set."""
        if self.ingest is None:
            self.ingest = IngestEngine(self.log, cfg=cfg, policy=policy)
        return self.ingest

    def shutdown(self) -> None:
        if self.health is not None:
            self.health.stop()
            self.health = None
        if self.ingest is not None:
            self.ingest.close()
            self.ingest = None
        if self.group:
            self.group.shutdown()


def device_size(capacity: int) -> int:
    return ring_offset() + capacity + 64


def build_replica_set(
    mode: str = "local",
    capacity: int = 1 << 20,
    n_backups: int = 0,
    write_quorum: Optional[int] = None,
    device_mode: str = "fast",
    cost: Optional[CostModel] = None,
    primary_id: str = "node0",
    open_existing: bool = False,
    pipeline_depth: int = 1,
    adaptive_depth: bool = False,
    salvage: bool = True,
    ingest: Optional[IngestConfig] = None,
    backup_ids: Optional[List[str]] = None,
    device="cuda",
) -> ReplicaSet:
    """Construct devices + transports + group + log for one deployment.

    ``pipeline_depth`` is the in-flight force-round limit — with
    ``adaptive_depth=True`` it is the CEILING of the log's adaptive
    controller (DESIGN.md §9) instead of a static setting.  ``salvage``
    gates partial-quorum salvage of failed rounds.  ``ingest`` attaches
    the group-commit ingestion front end with the given config.
    ``backup_ids`` names the backup servers (default node1..nodeN) —
    the shard router passes placement-derived names so every server id
    across a multi-shard deployment is globally unique.
    ``device`` is where the log's integrity hashing runs: ``"cuda"``
    needs a card and raises (before anything is built) without one,
    ``"cpu"`` uses the plain versions."""
    device = resolve_device(device)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    if mode == "local" and n_backups:
        raise ValueError("local mode has no backups")
    if mode != "local" and n_backups < 1:
        raise ValueError(f"{mode} mode needs >= 1 backup")
    if backup_ids is None:
        backup_ids = [f"node{i + 1}" for i in range(n_backups)]
    elif len(backup_ids) != n_backups:
        raise ValueError(f"backup_ids has {len(backup_ids)} names for "
                         f"{n_backups} backups")
    local_durable = mode != "remote_only"
    n_durable = n_backups + (1 if local_durable else 0)
    if write_quorum is None:
        write_quorum = (n_durable // 2) + 1
    cfg = LogConfig(capacity=capacity, write_quorum=write_quorum,
                    local_durable=local_durable,
                    pipeline_depth=pipeline_depth,
                    adaptive_depth=adaptive_depth, salvage=salvage)
    size = device_size(capacity)
    cost = cost or CostModel()
    # remote-only staging is DRAM: model as fast device (never persisted)
    primary_dev = PMEMDevice(
        size, mode=device_mode if local_durable else "fast",
        cost=cost, name=f"{primary_id}/pmem")
    servers = [
        ReplicaServer(PMEMDevice(size, mode=device_mode, cost=cost,
                                 name=f"{bid}/pmem"),
                      server_id=bid)
        for bid in backup_ids
    ]
    transports = [Transport(s, primary_id=primary_id, cost=cost)
                  for s in servers]
    group = ReplicationGroup(transports, write_quorum,
                             local_is_durable=local_durable) \
        if (servers or mode != "local") else None
    rs = ReplicaSet(mode=mode, cfg=cfg, primary_id=primary_id,
                    primary_dev=primary_dev, servers=servers,
                    transports=transports, group=group)
    rs.log = (Log.open if open_existing else Log.create)(
        primary_dev, cfg, repl=group, device=device)
    if ingest is not None:
        rs.attach_ingest(cfg=ingest)
    return rs
