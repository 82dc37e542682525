"""FLEX-equivalent baseline (Xu et al., ASPLOS'19 logging recipe).

Design characteristics reproduced (per §5.2):

  * header and payload are appended in **separate operations**, each with
    its own persist (the paper: "it appends the record header and payload
    in separate operations" — two flush+fence pairs), plus the tail
    update with a third persist;
  * per-record checksums (recovery cost comparable to Arcadia, Fig. 7a);
  * one global lock (no concurrency);
  * no replication.
"""

from __future__ import annotations

import struct
import threading
import zlib
from typing import Iterator, List, Tuple

from ..pmem import PMEMDevice
from .common import append_batch_looped

_HDR = struct.Struct("<QQ")          # tail, count
_REC = struct.Struct("<QII")         # lsn, size, crc


class FlexLog:
    name = "flex"
    HEADER = 64

    def __init__(self, dev: PMEMDevice, capacity: int):
        self.dev = dev
        self.capacity = capacity
        self._lock = threading.Lock()
        self._tail = 0
        self._count = 0
        dev.write(0, _HDR.pack(0, 0))
        dev.persist(0, _HDR.size)

    def append(self, data: bytes) -> Tuple[int, float]:
        with self._lock:
            n = len(data)
            if self._tail + _REC.size + n > self.capacity:
                raise RuntimeError("flex log full")
            off = self.HEADER + self._tail
            lsn = self._count + 1
            # operation 1: header (own persist)
            vns = self.dev.write(off, _REC.pack(lsn, n, zlib.crc32(data)))
            vns += self.dev.persist(off, _REC.size)
            # operation 2: payload (own persist)
            vns += self.dev.write(off + _REC.size, data)
            vns += self.dev.persist(off + _REC.size, n)
            self._tail += _REC.size + n
            self._count = lsn
            # operation 3: tail pointer
            vns += self.dev.write(0, _HDR.pack(self._tail, self._count))
            vns += self.dev.persist(0, _HDR.size)
            return lsn, vns

    def append_batch(self, payloads: List[bytes]) -> Tuple[List[int], float]:
        return append_batch_looped(self, payloads)

    def iter_records(self) -> Iterator[Tuple[int, bytes]]:
        tail, count = _HDR.unpack(self.dev.read(0, _HDR.size))
        pos = 0
        while pos < tail:
            lsn, n, crc = _REC.unpack(
                self.dev.read(self.HEADER + pos, _REC.size))
            data = self.dev.read(self.HEADER + pos + _REC.size, n)
            if zlib.crc32(data) != crc:
                return                      # integrity check (like Arcadia)
            yield lsn, data
            pos += _REC.size + n

    @classmethod
    def open(cls, dev: PMEMDevice, capacity: int) -> "FlexLog":
        log = cls.__new__(cls)
        log.dev, log.capacity = dev, capacity
        log._lock = threading.Lock()
        log._tail, log._count = _HDR.unpack(dev.read(0, _HDR.size))
        return log
