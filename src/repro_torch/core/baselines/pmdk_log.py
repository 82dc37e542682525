"""PMDK libpmemlog-equivalent baseline.

Design characteristics reproduced (per §5.2 and the PMDK sources):

  * one global lock around the whole append (no concurrency);
  * append = copy payload -> persist payload -> **update the persisted
    tail pointer -> persist it** (the extra flush+fence per append that
    Fig. 5a/b charges for);
  * no per-record checksums: recovery trusts the tail pointer and cannot
    detect torn or corrupted records (Table 1: ✗ media errors);
  * no replication (Table 1: ✗ node failure / partition).
"""

from __future__ import annotations

import struct
import threading
from typing import Iterator, List, Tuple

from ..pmem import PMEMDevice
from .common import append_batch_looped

_HDR = struct.Struct("<QQ")      # write_offset (tail), n_records


class PMDKLog:
    name = "pmdk"
    HEADER = 64                  # one cache line, like pmemlog's header

    def __init__(self, dev: PMEMDevice, capacity: int):
        self.dev = dev
        self.capacity = capacity
        self._lock = threading.Lock()
        self._tail = 0
        self._count = 0
        dev.write(0, _HDR.pack(0, 0))
        dev.persist(0, _HDR.size)

    def append(self, data: bytes) -> Tuple[int, float]:
        with self._lock:                      # coarse isolation
            n = len(data)
            if self._tail + 8 + n > self.capacity:
                raise RuntimeError("pmemlog full")
            off = self.HEADER + self._tail
            vns = self.dev.write(off, struct.pack("<Q", n))
            vns += self.dev.write(off + 8, data)
            vns += self.dev.persist(off, 8 + n)          # flush payload
            self._tail += 8 + n
            self._count += 1
            vns += self.dev.write(0, _HDR.pack(self._tail, self._count))
            vns += self.dev.persist(0, _HDR.size)        # flush tail ptr
            return self._count, vns

    def append_batch(self, payloads: List[bytes]) -> Tuple[List[int], float]:
        return append_batch_looped(self, payloads)

    def iter_records(self) -> Iterator[Tuple[int, bytes]]:
        tail, count = _HDR.unpack(self.dev.read(0, _HDR.size))
        pos, i = 0, 0
        while pos < tail and i < count:
            (n,) = struct.unpack("<Q", self.dev.read(self.HEADER + pos, 8))
            # NO integrity check: torn/corrupt data is surfaced verbatim
            yield i + 1, self.dev.read(self.HEADER + pos + 8, n)
            pos += 8 + n
            i += 1

    @classmethod
    def open(cls, dev: PMEMDevice, capacity: int) -> "PMDKLog":
        log = cls.__new__(cls)
        log.dev, log.capacity = dev, capacity
        log._lock = threading.Lock()
        log._tail, log._count = _HDR.unpack(dev.read(0, _HDR.size))
        return log
