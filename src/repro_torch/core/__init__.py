"""Arcadia core in PyTorch: the paper's replicated PMEM log.

Public surface (the JAX package's, module for module):

  PMEMDevice / CostModel        — simulated PMEM with real volatility
  VirtualTimeline               — per-resource modelled-time engine (§14)
  persist / write_and_force     — persistence + replication primitives
  IntegrityRegion / AtomicRegion— integrity + atomicity primitives
  Log / LogConfig               — the log (reserve/copy/complete/force)
  force_policy.make_policy      — sync / group / freq force policies
  build_replica_set             — local / local+remote / remote_only setups
  quorum_recover / CopyAccessor — §4.2 recovery protocol
  ClusterManager                — membership / election / fencing contract
  Scrubber / resync_backup /
    FailureDetector / HealthMonitor — self-healing lifecycle (DESIGN.md §11)
  LogRouter / ShardSpec /
    ShardPlacement / SnapshotCut  — sharded multi-log router (DESIGN.md §12)
  LogLifecycle / TrimError      — checkpoint+truncate lifecycle (§13)
  baselines                     — PMDK / FLEX / Query Fresh comparators

The log's integrity hash runs on the device given to ``Log`` /
``build_replica_set`` / ``quorum_recover`` / ``LogRouter`` (``"cuda"`` by
default, where it is a CUDA kernel; ``"cpu"`` for the plain torch
version); the scrubber, the lifecycle's reopen and the router's recovery
hash on their log's or router's device.  PMEM images stay in host memory.
"""

from .pmem import CACHE_LINE, ATOM, CostModel, DeviceStats, PMEMDevice
from .timeline import Interval, VirtualTimeline
from .primitives import (AtomicRegion, ForceRound, IntegrityRegion, LF_REP,
                         ORDERINGS, PARALLEL, REP_LF, SalvageForceRound,
                         persist, reissue_segs, write_and_force,
                         write_and_force_segs, write_and_force_segs_async)
from .log import (AckRateEstimator, Batch, CorruptLogError, Log, LogConfig,
                  LogError, LogFullError, Superline, TrimError)
from .lifecycle import LifecycleConfig, LogLifecycle, TrimReport
from .force_policy import (ForcePolicy, FreqPolicy, GroupCommitPolicy,
                           SyncPolicy, make_policy)
from .ingest import (IngestClosedError, IngestConfig, IngestEngine,
                     IngestError, IngestQueueFull, IngestShedError,
                     IngestTicket, latency_percentiles)
from .transport import (QuorumError, QuorumRound, ReplicaServer,
                        ReplicationGroup, RoundSalvage, Transport,
                        TransportError)
from .replication import ReplicaSet, build_replica_set, device_size
from .recovery import CopyAccessor, RecoveryError, RecoveryReport, \
    quorum_recover
from .cluster import ClusterManager, Node
from .health import (FailureDetector, HealthMonitor, HeartbeatConfig,
                     ResyncReport, ScrubConfig, ScrubReport, Scrubber,
                     resync_backup)
from .router import (LogRouter, RouterError, RouterRecovery, Shard,
                     ShardPlacement, ShardRecovery, ShardSpec, SnapshotCut,
                     UnknownShardError, payload_digest, stream_digest)

__all__ = [
    "CACHE_LINE", "ATOM", "CostModel", "DeviceStats", "PMEMDevice",
    "Interval", "VirtualTimeline",
    "AtomicRegion", "ForceRound", "IntegrityRegion", "LF_REP", "ORDERINGS",
    "PARALLEL", "REP_LF", "SalvageForceRound", "persist", "reissue_segs",
    "write_and_force", "write_and_force_segs", "write_and_force_segs_async",
    "AckRateEstimator", "Batch", "CorruptLogError", "Log", "LogConfig",
    "LogError", "LogFullError", "Superline", "TrimError",
    "LifecycleConfig", "LogLifecycle", "TrimReport",
    "ForcePolicy", "FreqPolicy", "GroupCommitPolicy", "SyncPolicy",
    "make_policy",
    "IngestClosedError", "IngestConfig", "IngestEngine", "IngestError",
    "IngestQueueFull", "IngestShedError", "IngestTicket",
    "latency_percentiles",
    "QuorumError", "QuorumRound", "ReplicaServer", "ReplicationGroup",
    "RoundSalvage", "Transport", "TransportError",
    "ReplicaSet", "build_replica_set", "device_size",
    "CopyAccessor", "RecoveryError", "RecoveryReport", "quorum_recover",
    "ClusterManager", "Node",
    "FailureDetector", "HealthMonitor", "HeartbeatConfig", "ResyncReport",
    "ScrubConfig", "ScrubReport", "Scrubber", "resync_backup",
    "LogRouter", "RouterError", "RouterRecovery", "Shard", "ShardPlacement",
    "ShardRecovery", "ShardSpec", "SnapshotCut", "UnknownShardError",
    "payload_digest", "stream_digest",
]
