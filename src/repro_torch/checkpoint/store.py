"""Replicated object stores for checkpoint shards.

The Arcadia log holds *manifests* (small, latency-critical — PMEM tier);
shard payloads go to bulk object stores, one per replica node, with the
same quorum discipline as the log: puts fan out to all replicas and
succeed once W acks arrive; gets validate integrity (codec CRCs +
manifest checksum) and fall back across replicas, repairing bad copies
on read (read-repair).  Failure injection mirrors Table 1: a store can
die (node failure), drop puts (partition), or corrupt objects (media
error).

The JAX package's stores, on the port's ``core.transport.QuorumError``.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from ..core.transport import QuorumError
from .codec import ShardCorruptError, shard_checksum


class StoreError(Exception):
    pass


class ObjectStore:
    """One replica's bulk store (a host's local disk / SSD)."""

    def __init__(self, name: str = "store0"):
        self.name = name
        self.dead = False
        self.drop_puts = False
        self._lock = threading.Lock()
        self._data: Dict[str, bytes] = {}

    def put(self, key: str, data: bytes) -> None:
        if self.dead or self.drop_puts:
            raise StoreError(f"{self.name}: unreachable")
        with self._lock:
            self._data[key] = bytes(data)

    def get(self, key: str) -> bytes:
        if self.dead:
            raise StoreError(f"{self.name}: unreachable")
        with self._lock:
            if key not in self._data:
                raise KeyError(key)
            return self._data[key]

    def delete(self, key: str) -> None:
        if self.dead:
            raise StoreError(f"{self.name}: unreachable")
        with self._lock:
            self._data.pop(key, None)

    def keys(self) -> List[str]:
        with self._lock:
            return sorted(self._data)

    # failure injection --------------------------------------------------- #
    def corrupt(self, key: str, seed: int = 0, nbits: int = 8) -> None:
        rng = np.random.default_rng(seed)
        with self._lock:
            buf = bytearray(self._data[key])
            for _ in range(nbits):
                pos = int(rng.integers(0, len(buf)))
                buf[pos] ^= 1 << int(rng.integers(0, 8))
            self._data[key] = bytes(buf)

    def truncate(self, key: str, keep: int) -> None:
        """Torn write: only a prefix of the object reached the media."""
        with self._lock:
            self._data[key] = self._data[key][:keep]


class FileStore(ObjectStore):
    """Directory-backed replica (used by the examples; same semantics)."""

    def __init__(self, root: str, name: str = "filestore"):
        super().__init__(name)
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key.replace("/", "__"))

    def put(self, key: str, data: bytes) -> None:
        if self.dead or self.drop_puts:
            raise StoreError(f"{self.name}: unreachable")
        tmp = self._path(key) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())           # the persistence primitive
        os.replace(tmp, self._path(key))   # atomic publish

    def get(self, key: str) -> bytes:
        if self.dead:
            raise StoreError(f"{self.name}: unreachable")
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise KeyError(key) from None

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def keys(self) -> List[str]:
        return sorted(k.replace("__", "/") for k in os.listdir(self.root)
                      if not k.endswith(".tmp"))


class ReplicatedStore:
    """Quorum fan-out over N object stores (W write / R read quorum)."""

    def __init__(self, replicas: List[ObjectStore], write_quorum: int):
        if not (0 < write_quorum <= len(replicas)):
            raise ValueError("bad write quorum")
        self.replicas = list(replicas)
        self.write_quorum = write_quorum

    @property
    def read_quorum(self) -> int:
        return len(self.replicas) - self.write_quorum + 1

    def put(self, key: str, data: bytes) -> int:
        """Replicate to all; succeed at W acks.  Returns ack count."""
        acks = 0
        errs = []
        for r in self.replicas:
            try:
                r.put(key, data)
                acks += 1
            except StoreError as e:
                errs.append(str(e))
        if acks < self.write_quorum:
            raise QuorumError(
                f"shard put quorum not met ({acks}/{len(self.replicas)}, "
                f"need {self.write_quorum}): {errs}")
        return acks

    def get(self, key: str, expect_checksum: Optional[int] = None) -> bytes:
        """Read with validation + read-repair across replicas."""
        good: Optional[bytes] = None
        bad_replicas: List[ObjectStore] = []
        for r in self.replicas:
            try:
                data = r.get(key)
            except (StoreError, KeyError):
                bad_replicas.append(r)
                continue
            if expect_checksum is not None and \
                    shard_checksum(data) != expect_checksum:
                bad_replicas.append(r)
                continue
            good = data
            break
        if good is None:
            raise ShardCorruptError(
                f"no intact replica of {key!r} "
                f"({len(bad_replicas)}/{len(self.replicas)} bad)")
        for r in bad_replicas:            # read-repair
            try:
                r.put(key, good)
            except StoreError:
                pass
        return good

    def delete(self, key: str) -> None:
        for r in self.replicas:
            try:
                r.delete(key)
            except StoreError:
                pass
