"""Query Fresh-equivalent baseline (Wang et al., VLDB'18).

Design characteristics reproduced (per §5.6 / Table 1):

  * replicated log shipping over RDMA to backups (✓ node failure,
    ✓ partition), but **no integrity checking** (✗ media errors — silent
    corruption is surfaced);
  * group commit with a shared window counter, **limited log
    concurrency**: the window mutex is held across the batch bookkeeping
    and appends serialize on a coarse lock (the paper: "it only enables
    limited log concurrency ... lower throughput than Arcadia but less
    impacted by the synchronization overheads of group commit").
"""

from __future__ import annotations

import struct
import threading
from typing import Iterator, List, Optional, Tuple

from ..pmem import PMEMDevice
from .common import append_batch_looped
from ..transport import ReplicationGroup

_HDR = struct.Struct("<QQ")      # tail, count
_REC = struct.Struct("<QI")      # lsn, size


class QueryFreshLog:
    name = "query_fresh"
    HEADER = 64

    def __init__(self, dev: PMEMDevice, capacity: int,
                 repl: Optional[ReplicationGroup] = None,
                 group_size: int = 128):
        self.dev = dev
        self.capacity = capacity
        self.repl = repl
        self.group_size = group_size
        self._lock = threading.Lock()
        self._tail = 0
        self._count = 0
        self._window = 0          # shared group-commit counter
        self._shipped = 0         # byte offset already shipped to backups
        dev.write(0, _HDR.pack(0, 0))
        dev.persist(0, _HDR.size)

    def append(self, data: bytes) -> Tuple[int, float]:
        with self._lock:          # coarse lock: append + window bookkeeping
            n = len(data)
            if self._tail + _REC.size + n > self.capacity:
                raise RuntimeError("query-fresh log full")
            off = self.HEADER + self._tail
            lsn = self._count + 1
            vns = self.dev.write(off, _REC.pack(lsn, n))
            vns += self.dev.write(off + _REC.size, data)
            self._tail += _REC.size + n
            self._count = lsn
            self._window += 1
            if self._window >= self.group_size:
                self._window = 0
                vns += self._ship_locked()
            return lsn, vns

    def append_batch(self, payloads: List[bytes]) -> Tuple[List[int], float]:
        return append_batch_looped(self, payloads)

    def flush(self) -> float:
        with self._lock:
            return self._ship_locked()

    def _ship_locked(self) -> float:
        start, end = self._shipped, self._tail
        if end == start:
            return 0.0
        vns = self.dev.persist(self.HEADER + start, end - start)
        if self.repl is not None:
            vns += self.repl.replicate(self.dev, self.HEADER + start,
                                       self.HEADER + start, end - start)
        vns += self.dev.write(0, _HDR.pack(self._tail, self._count))
        vns += self.dev.persist(0, _HDR.size)
        if self.repl is not None:
            vns += self.repl.broadcast_bytes(
                self.dev.read(0, _HDR.size), 0)
        self._shipped = end
        return vns

    def iter_records(self) -> Iterator[Tuple[int, bytes]]:
        tail, count = _HDR.unpack(self.dev.read(0, _HDR.size))
        pos = 0
        while pos < tail:
            lsn, n = _REC.unpack(self.dev.read(self.HEADER + pos, _REC.size))
            # no checksum: corruption passes through silently
            yield lsn, self.dev.read(self.HEADER + pos + _REC.size, n)
            pos += _REC.size + n

    @classmethod
    def open(cls, dev: PMEMDevice, capacity: int,
             repl: Optional[ReplicationGroup] = None,
             group_size: int = 128) -> "QueryFreshLog":
        log = cls.__new__(cls)
        log.dev, log.capacity, log.repl = dev, capacity, repl
        log.group_size, log._lock = group_size, threading.Lock()
        log._window = 0
        log._tail, log._count = _HDR.unpack(dev.read(0, _HDR.size))
        log._shipped = log._tail
        return log
