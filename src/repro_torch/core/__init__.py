"""Arcadia core in PyTorch: the replicated PMEM log's main path.

Public surface of this slice:

  PMEMDevice / CostModel        — simulated PMEM with real volatility
  VirtualTimeline               — per-resource modelled-time engine (§14)
  persist / write_and_force     — persistence + replication primitives
  IntegrityRegion / AtomicRegion— integrity + atomicity primitives
  Log / LogConfig               — the log (reserve/copy/complete/force)
  force_policy.make_policy      — sync / group / freq force policies
  IngestEngine                  — group-commit ingestion front end
  build_replica_set             — local / local+remote / remote_only setups
  quorum_recover / CopyAccessor — §4.2 recovery protocol

The log's integrity hash runs on the device given to ``Log`` /
``build_replica_set`` / ``quorum_recover`` (``"cuda"`` by default, where
it is a CUDA kernel; ``"cpu"`` for the plain torch version).  The
cluster manager, health lifecycle, shard router and trim lifecycle are
not ported yet.
"""

from .pmem import CACHE_LINE, ATOM, CostModel, DeviceStats, PMEMDevice
from .timeline import Interval, VirtualTimeline
from .primitives import (AtomicRegion, ForceRound, IntegrityRegion, LF_REP,
                         ORDERINGS, PARALLEL, REP_LF, SalvageForceRound,
                         persist, reissue_segs, write_and_force,
                         write_and_force_segs, write_and_force_segs_async)
from .log import (AckRateEstimator, Batch, CorruptLogError, Log, LogConfig,
                  LogError, LogFullError, Superline, TrimError)
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

__all__ = [
    "CACHE_LINE", "ATOM", "CostModel", "DeviceStats", "PMEMDevice",
    "Interval", "VirtualTimeline",
    "AtomicRegion", "ForceRound", "IntegrityRegion", "LF_REP", "ORDERINGS",
    "PARALLEL", "REP_LF", "SalvageForceRound", "persist", "reissue_segs",
    "write_and_force", "write_and_force_segs", "write_and_force_segs_async",
    "AckRateEstimator", "Batch", "CorruptLogError", "Log", "LogConfig",
    "LogError", "LogFullError", "Superline", "TrimError",
    "ForcePolicy", "FreqPolicy", "GroupCommitPolicy", "SyncPolicy",
    "make_policy",
    "IngestClosedError", "IngestConfig", "IngestEngine", "IngestError",
    "IngestQueueFull", "IngestShedError", "IngestTicket",
    "latency_percentiles",
    "QuorumError", "QuorumRound", "ReplicaServer", "ReplicationGroup",
    "RoundSalvage", "Transport", "TransportError",
    "ReplicaSet", "build_replica_set", "device_size",
    "CopyAccessor", "RecoveryError", "RecoveryReport", "quorum_recover",
]
