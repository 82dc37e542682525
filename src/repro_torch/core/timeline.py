"""Discrete-event virtual timeline for the cost model (DESIGN.md §14).

The cost model (``pmem.CostModel``) prices individual hardware operations
in virtual nanoseconds (vns).  Before this engine existed, the log simply
summed every retired force round's vns into ``force_vns_total`` — a
*serial* sum that is correct work accounting but wrong *time* accounting:
pipelined rounds overlap on independent resources (the device flush port,
each replica's RDMA wire, the leader CPU), so the modelled latency of an
overlapped schedule is the max over per-resource busy intervals, not the
sum of round costs.

``VirtualTimeline`` fixes this with the textbook discrete-event device:
each named resource keeps a monotonically advancing virtual clock, and
every charged operation becomes an interval

    start      = max(dependency ends, resource free time)
    busy_until = start + busy        (resource occupied; clock advances)
    end        = busy_until + latency  (result visible; clock does NOT
                                        advance — LogP-style latency)

The busy/latency split matters for wires: an RDMA post occupies the lane
only while bytes are being read and pushed onto the wire; the RTT and the
remote persist happen *after* the lane is free for the next round's post.
Modelling the full round cost as occupancy would serialise the pipeline
on the wire and hide exactly the overlap this engine exists to expose.

Resources are created lazily on first use and named by convention:

* ``"cpu"``            — leader CPU issuing doorbells / building rounds
* ``"flush"``          — the local device flush port
* ``"wire:<server>"``  — the RDMA lane to one replica
* ``"scrub"``          — background scrubber read bandwidth

All methods are thread-safe; schedules from concurrent threads interleave
in lock-acquisition order, which the log keeps deterministic by only
scheduling from the (ordered, head-first) retirement path.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict

__all__ = ["Interval", "VirtualTimeline"]


@dataclass(frozen=True, slots=True)
class Interval:
    """One scheduled operation on one resource (all times in vns)."""

    resource: str
    start: float        # when the op began (deps met AND resource free)
    busy_until: float   # resource occupied until here
    end: float          # result available here (busy_until + latency)

    @property
    def busy(self) -> float:
        return self.busy_until - self.start

    @property
    def latency(self) -> float:
        return self.end - self.busy_until


class VirtualTimeline:
    """Per-resource monotone virtual clocks with interval scheduling."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._clocks: Dict[str, float] = {}
        self._horizon = 0.0

    def schedule(self, resource: str, busy: float = 0.0,
                 latency: float = 0.0, after: float = 0.0) -> Interval:
        """Charge an operation and return its interval.

        ``after`` is the dependency horizon: the op cannot start before
        every input it consumes exists.  The resource clock advances to
        ``busy_until`` only; ``latency`` extends the interval's end
        without occupying the resource.
        """
        if busy < 0.0 or latency < 0.0:
            raise ValueError("busy/latency must be non-negative")
        with self._lock:
            free = self._clocks.get(resource, 0.0)
            start = after if after > free else free
            busy_until = start + busy
            end = busy_until + latency
            self._clocks[resource] = busy_until
            if end > self._horizon:
                self._horizon = end
            return Interval(resource, start, busy_until, end)

    def now(self, resource: str) -> float:
        """The resource's current free time (0.0 if never used)."""
        with self._lock:
            return self._clocks.get(resource, 0.0)

    def clocks(self) -> Dict[str, float]:
        """Snapshot of every resource clock."""
        with self._lock:
            return dict(self._clocks)

    def makespan(self) -> float:
        """Max ``end`` over every interval ever scheduled."""
        with self._lock:
            return self._horizon
