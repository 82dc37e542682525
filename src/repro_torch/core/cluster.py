"""Minimal cluster-infrastructure contract (§4.2).

The paper assumes an external membership/quorum service (ZooKeeper) that
(a) tracks node liveness, (b) elects the active primary for each log
instance, and (c) informs backups of primary changes so they can fence
the old primary.  ``ClusterManager`` provides exactly that contract,
in-process and deterministic, so failover paths are unit-testable:

    cm = ClusterManager(nodes)
    cm.on_primary_change(lambda old, new: ...)
    cm.report_failure("node0")   # -> fence node0 everywhere, elect, notify
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from .transport import ReplicaServer


@dataclass
class Node:
    node_id: str
    server: Optional[ReplicaServer] = None    # None => client-only node
    alive: bool = True


@dataclass
class _ManagedGroup:
    """A replication group under degraded-quorum review (DESIGN.md §11)."""
    group: object                   # ReplicationGroup
    configured_w: int               # the W the operator asked for
    allow_degraded: bool            # policy: lower W instead of wedging?
    min_write_quorum: int           # never degrade below this


class ClusterManager:
    """Membership + leader election + fencing for one Arcadia log."""

    def __init__(self, nodes: List[Node], drain_timeout: float = 5.0,
                 name: str = ""):
        if not nodes:
            raise ValueError("cluster needs at least one node")
        self._lock = threading.Lock()
        self.name = name              # e.g. the owning shard id (§12)
        self.nodes: Dict[str, Node] = {n.node_id: n for n in nodes}
        self._primary = self._elect_locked()
        self._callbacks: List[Callable[[str, str], None]] = []
        self._logs: List = []             # logs whose pipelines we drain
        self._groups: List[_ManagedGroup] = []
        self._degraded = False
        self._degraded_events = 0
        self.drain_timeout = drain_timeout

    # -- force-pipeline fencing --------------------------------------------- #
    def attach_log(self, log) -> None:
        """Register a log whose pipelined force engine must settle before
        any failover re-wiring: in-flight durability rounds either retire
        or fail *before* the surviving backups fence the old primary, so
        no doorbell posted under the old epoch can straddle the epoch
        change (§4.2 Handling Primary Failure + DESIGN.md §8)."""
        self._logs.append(log)

    def detach_log(self, log) -> None:
        if log in self._logs:
            self._logs.remove(log)

    # -- degraded-quorum review (DESIGN.md §11) ----------------------------- #
    def attach_group(self, group, allow_degraded: bool = False,
                     min_write_quorum: int = 1) -> None:
        """Put a ReplicationGroup's write quorum under membership review.

        Strict mode (``allow_degraded=False``, the default) only records
        the configured W so ``stats()`` can report reachability: losing a
        quorum of copies wedges writes with QuorumError, exactly as
        before.  With ``allow_degraded=True`` the manager *temporarily*
        lowers the group's effective W to the number of reachable durable
        copies (never below ``min_write_quorum``) when membership drops,
        and restores the configured W once the copies are back — raising
        an alert flag in ``stats()`` the whole time, because every write
        acked under a degraded quorum has fewer durable copies than the
        operator asked for.  Restoration happens on ``report_recovery``,
        which the rejoin path calls only AFTER resync — a returning
        backup with a gap must not count toward quorum."""
        if not (0 < int(min_write_quorum) <= group.write_quorum):
            raise ValueError(
                f"min_write_quorum={min_write_quorum} invalid for "
                f"W={group.write_quorum}")
        with self._lock:
            self._groups.append(_ManagedGroup(
                group, group.write_quorum, bool(allow_degraded),
                int(min_write_quorum)))
            self._review_quorum_locked()

    def _review_quorum_locked(self) -> None:
        """Re-derive each managed group's effective write quorum from
        current membership.  Reachable durable copies = the primary's
        local copy (if durable) + each backup lane whose node is alive
        (nodes the manager does not track are assumed alive).  The
        QuorumRound machinery reads ``group.write_quorum`` per round, so
        the new value governs every round issued after this review."""
        alive = {nid for nid, n in self.nodes.items() if n.alive}
        degraded = False
        for mg in self._groups:
            g = mg.group
            reachable = (1 if g.local_is_durable else 0) + sum(
                1 for t in g.transports
                if t.server.server_id not in self.nodes
                or t.server.server_id in alive)
            if reachable >= mg.configured_w or not mg.allow_degraded:
                g.write_quorum = mg.configured_w
                if reachable < mg.configured_w:
                    degraded = True      # strict mode: wedged, still alert
            else:
                g.write_quorum = max(mg.min_write_quorum, reachable)
                degraded = True
        if degraded and not self._degraded:
            self._degraded_events += 1
        self._degraded = degraded

    def _drain_logs(self) -> None:
        for log in self._logs:
            try:
                # surface_errors=False: settle the pipeline but leave any
                # deferred round failure stashed — it must still raise on
                # the log's next force/drain, not vanish into failover
                log.drain(timeout=self.drain_timeout, surface_errors=False)
            except Exception:
                # drain timeout: failover proceeds regardless (the
                # pipeline may be stuck precisely because the primary
                # died); nothing was consumed
                pass
            try:
                # the old primary's salvage stash dies with its epoch:
                # its snapshotted wire images must never be re-issued to
                # backups that are about to fence it — the new primary
                # re-derives the tail through quorum recovery instead
                log.abandon_salvage()
            except Exception:
                pass

    # -- queries ----------------------------------------------------------- #
    @property
    def primary(self) -> str:
        with self._lock:
            return self._primary

    def alive_nodes(self) -> List[str]:
        with self._lock:
            return [n.node_id for n in self.nodes.values() if n.alive]

    def has_quorum(self, needed: int) -> bool:
        return len(self.alive_nodes()) >= needed

    # -- membership events -------------------------------------------------- #
    def on_primary_change(self, cb: Callable[[str, str], None]) -> None:
        self._callbacks.append(cb)

    def report_failure(self, node_id: str) -> Optional[str]:
        """Liveness detector verdict: ``node_id`` is dead.  If it was the
        primary: drain attached force pipelines, fence the old primary on
        every surviving server, elect a successor, and fire callbacks
        (app migration + log recovery hook).  Returns the new primary id
        if a failover happened."""
        if node_id == self.primary:
            # settle in-flight durability rounds before the epoch fence
            # goes up (outside _lock: drain only touches log internals)
            self._drain_logs()
        with self._lock:
            node = self.nodes.get(node_id)
            if node is None or not node.alive:
                return None
            node.alive = False
            if node_id != self._primary:
                # a backup died: no election, but the write quorum may
                # now be unreachable — review degraded mode either way
                self._review_quorum_locked()
                return None
            old = self._primary
            # backups immediately close connections with the old primary
            for n in self.nodes.values():
                if n.alive and n.server is not None:
                    n.server.fence(old)
            self._primary = self._elect_locked()
            new = self._primary
            self._review_quorum_locked()
        for cb in self._callbacks:
            cb(old, new)
        return new

    def report_recovery(self, node_id: str) -> None:
        """A failed node rejoined (as a backup; it stays fenced as primary
        until re-elected through a fresh epoch).  Callers resync the
        node FIRST (``ReplicaSet.recover_backup`` / health.resync_backup):
        restoring a degraded write quorum here is only safe once the
        returning copy holds the full durable prefix."""
        with self._lock:
            if node_id in self.nodes:
                self.nodes[node_id].alive = True
                self._review_quorum_locked()

    def stats(self) -> dict:
        """Membership + degraded-quorum alert snapshot.  ``degraded``
        is the alert flag: some managed group has fewer reachable
        durable copies than its configured W (its effective W shows
        whether policy lowered the bar or writes are wedging)."""
        with self._lock:
            return dict(
                name=self.name,
                primary=self._primary,
                alive=sorted(n.node_id for n in self.nodes.values()
                             if n.alive),
                failed=sorted(n.node_id for n in self.nodes.values()
                              if not n.alive),
                degraded=self._degraded,
                degraded_events=self._degraded_events,
                write_quorums=[
                    dict(configured=mg.configured_w,
                         effective=mg.group.write_quorum,
                         allow_degraded=mg.allow_degraded)
                    for mg in self._groups])

    def _elect_locked(self) -> str:
        alive = sorted(nid for nid, n in self.nodes.items() if n.alive)
        if not alive:
            raise RuntimeError("no live nodes: cluster lost")
        return alive[0]
