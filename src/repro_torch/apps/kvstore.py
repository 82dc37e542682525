"""A durable key-value store with a pluggable write-ahead log — the
paper's RocksDB/Masstree integrations (§5.6), distilled.

Puts follow the WAL discipline: append a redo record (key, value) to
the log, force per the configured policy, then apply to the in-memory
table.  Recovery replays the log.  With the Arcadia backend the
*fine-grained* interface is used (reserve → copy → complete →
policy-driven force), which is exactly the ~200-LoC RocksDB integration
the paper describes; baseline backends only offer a monolithic append.
"""

from __future__ import annotations

import struct
import threading
import zlib
from typing import Dict, Iterable, List, Optional, Tuple, Union

from ..core.force_policy import ForcePolicy, SyncPolicy
from ..core.ingest import IngestConfig, IngestEngine, IngestTicket
from ..core.log import Log
from ..core.router import LogRouter, ShardPlacement, ShardSpec, SnapshotCut

_REC = struct.Struct("<II")      # key_len, val_len
_TREC = struct.Struct("<HII")    # tenant_len, key_len, val_len


def encode_put(key: bytes, val: bytes) -> bytes:
    return _REC.pack(len(key), len(val)) + key + val


def decode_put(payload: bytes) -> Tuple[bytes, bytes]:
    klen, vlen = _REC.unpack_from(payload, 0)
    off = _REC.size
    return payload[off : off + klen], payload[off + klen : off + klen + vlen]


def encode_tenant_put(tenant: bytes, key: bytes, val: bytes) -> bytes:
    """Multi-tenant redo record: the tenant id travels IN the payload so
    recovery can rebuild per-tenant tables from the raw shards alone."""
    return _TREC.pack(len(tenant), len(key), len(val)) + tenant + key + val


def decode_tenant_put(payload: bytes) -> Tuple[bytes, bytes, bytes]:
    tlen, klen, vlen = _TREC.unpack_from(payload, 0)
    off = _TREC.size
    tenant = payload[off : off + tlen]
    key = payload[off + tlen : off + tlen + klen]
    val = payload[off + tlen + klen : off + tlen + klen + vlen]
    return tenant, key, val


class DurableKV:
    """KV store over the Arcadia log (fine-grained write path)."""

    def __init__(self, log: Log, policy: Optional[ForcePolicy] = None,
                 ingest: Union[None, bool, IngestConfig,
                               IngestEngine] = None):
        """``ingest`` switches the write path to the group-commit
        ingestion front end (DESIGN.md §10): pass True, an
        IngestConfig, or a prebuilt IngestEngine.  put() then submits
        to the engine's bounded queue and blocks until its record's
        durable ack — concurrent put()s from many threads coalesce
        into one batched reserve/complete and shared pipeline rounds,
        instead of each paying its own."""
        self.log = log
        self.policy = policy or SyncPolicy()
        self.ingest: Optional[IngestEngine] = None
        if ingest:
            if isinstance(ingest, IngestEngine):
                self.ingest = ingest
            else:
                cfg = ingest if isinstance(ingest, IngestConfig) else None
                self.ingest = IngestEngine(log, cfg=cfg, policy=self.policy)
        self._table: Dict[bytes, bytes] = {}
        self._lock = threading.Lock()

    def put(self, key: bytes, val: bytes) -> int:
        if self.ingest is not None:
            lsn = self.ingest.append(encode_put(key, val)).wait()
            with self._lock:
                self._table[key] = val
            return lsn
        payload = encode_put(key, val)
        rid, ptr = self.log.reserve(len(payload))
        if ptr is not None:
            ptr[:] = payload          # assemble directly in PMEM
        else:
            self.log.copy(rid, payload)
        self.log.complete(rid)
        self.policy.on_complete(self.log, rid)
        with self._lock:
            self._table[key] = val
        return rid

    def put_async(self, key: bytes, val: bytes) -> IngestTicket:
        """Group-commit path only: submit and return the IngestTicket
        without waiting for the durable ack.  The table is applied
        immediately — the same apply-before-durable exposure a freq
        policy already gives the scalar path; wait on the ticket (or
        flush) for the durability point."""
        if self.ingest is None:
            raise ValueError("put_async requires the ingest front end")
        t = self.ingest.append(encode_put(key, val))
        with self._lock:
            self._table[key] = val
        return t

    def put_many(self, items: Iterable[Tuple[bytes, bytes]]) -> List[int]:
        """Batched WAL path: one reserve_batch / complete_batch round and
        one policy decision for the whole write set (a RocksDB WriteBatch
        analogue)."""
        items = list(items)
        if not items:
            return []
        payloads = [encode_put(k, v) for k, v in items]
        batch = self.log.reserve_batch([len(p) for p in payloads])
        self.log.copy_batch(batch, payloads)
        self.log.complete_batch(batch)
        self.policy.on_complete_batch(self.log, batch.lsns)
        with self._lock:
            for k, v in items:
                self._table[k] = v
        return batch.lsns

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._table.get(key)

    def __len__(self) -> int:
        with self._lock:
            return len(self._table)

    def flush(self) -> None:
        """Force everything accepted so far and wait for the log's
        pipelined force engine to empty: on return every put is durable
        on a write quorum, or the round failure (QuorumError — including
        one deferred by a non-blocking ``wait=False`` policy) has been
        raised here.  On the group-commit path this drains the ingest
        engine: every outstanding ticket is acked or failed first."""
        if self.ingest is not None:
            self.ingest.drain()
            return
        self.policy.drain(self.log)

    def close(self) -> None:
        """Shut down the ingest front end (no-op on the scalar path)."""
        if self.ingest is not None:
            self.ingest.close()

    @classmethod
    def recover(cls, log: Log, policy: Optional[ForcePolicy] = None
                ) -> "DurableKV":
        kv = cls(log, policy)
        for _, payload in log.iter_records():
            k, v = decode_put(payload)
            kv._table[k] = v
        return kv


class MultiTenantKV:
    """Multi-tenant KV front end over the shard router (DESIGN.md §12).

    Each tenant owns a DISJOINT group of shards — its own rings, replica
    lanes, force pipelines and (optional) ingest engines — created with
    per-tenant deployment config (quorum, device mode, pipeline depth,
    ingest policy).  Isolation guarantees:

      * traffic: a tenant's puts route only within its own shard group
        (keyed CRC32 over the group), so one tenant's load never queues
        behind another's ordering domain;
      * faults: ``fail_backup``/``kill_backup_midwire`` are
        tenant-scoped and refuse to touch another tenant's shards — and
        a real fault on one tenant's lane degrades only that tenant's
        quorum (sibling tenants' engines see zero failures);
      * stats: ``tenant_stats`` aggregates only the tenant's shards.

    ``snapshot_view`` uses the router's two-phase cut to materialise a
    coherent cross-tenant, cross-shard table state without quiescing
    writers.  ``device`` is where the shards' integrity hashes run (the
    router's, ``"cuda"`` by default; ``"cpu"`` for the plain versions)."""

    def __init__(self, placement: Optional[ShardPlacement] = None,
                 device="cuda"):
        self.router = LogRouter(placement, device=device)
        self._tenants: Dict[bytes, List[str]] = {}   # tenant -> shard ids
        self._tables: Dict[bytes, Dict[bytes, bytes]] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _tname(tenant: Union[str, bytes]) -> bytes:
        return tenant.encode() if isinstance(tenant, str) else bytes(tenant)

    # -- tenancy ------------------------------------------------------------ #
    def add_tenant(self, tenant: Union[str, bytes], n_shards: int = 1,
                   policy: Optional[ForcePolicy] = None,
                   **spec_kw) -> List[str]:
        """Provision ``n_shards`` shards named ``<tenant>/s<i>`` with this
        tenant's deployment config (``spec_kw`` = ShardSpec fields, e.g.
        ``mode='local+remote', n_backups=2, ingest=IngestConfig()``)."""
        t = self._tname(tenant)
        if n_shards < 1:
            raise ValueError("a tenant needs at least one shard")
        with self._lock:
            if t in self._tenants:
                raise ValueError(f"tenant {t!r} already exists")
            self._tenants[t] = []
            self._tables[t] = {}
        sids = []
        for i in range(n_shards):
            sid = f"{t.decode()}/s{i}"
            self.router.add_shard(ShardSpec(shard_id=sid, **spec_kw),
                                  policy=policy)
            sids.append(sid)
        with self._lock:
            self._tenants[t] = sids
        return sids

    def tenants(self) -> List[bytes]:
        with self._lock:
            return list(self._tenants)

    def _shards_of(self, t: bytes) -> List[str]:
        with self._lock:
            try:
                return list(self._tenants[t])
            except KeyError:
                raise KeyError(f"unknown tenant {t!r}") from None

    def _shard_for(self, t: bytes, key: bytes) -> str:
        sids = self._shards_of(t)
        return sids[zlib.crc32(key) % len(sids)]

    # -- data path ----------------------------------------------------------- #
    def put(self, tenant: Union[str, bytes], key: bytes, val: bytes) -> int:
        """Durable put on the tenant's routed shard (group-commit when the
        tenant's shards carry an ingest engine, sync scalar otherwise)."""
        t = self._tname(tenant)
        sid = self._shard_for(t, key)
        payload = encode_tenant_put(t, key, val)
        sh = self.router.shard(sid)
        if sh.engine is not None:
            lsn = sh.engine.append(payload).wait()
        else:
            _, lsn = self.router.append(payload, shard_id=sid)
        with self._lock:
            self._tables[t][key] = val
        return lsn

    def put_async(self, tenant: Union[str, bytes], key: bytes,
                  val: bytes) -> IngestTicket:
        t = self._tname(tenant)
        sid = self._shard_for(t, key)
        _, ticket = self.router.submit(
            encode_tenant_put(t, key, val), shard_id=sid)
        with self._lock:
            self._tables[t][key] = val
        return ticket

    def get(self, tenant: Union[str, bytes],
            key: bytes) -> Optional[bytes]:
        t = self._tname(tenant)
        with self._lock:
            return self._tables[t].get(key)

    def flush(self, tenant: Union[str, bytes, None] = None,
              timeout: float = 30.0) -> None:
        """Settle one tenant's shards (or all): queues drained, pipelines
        empty, every accepted put durable or its failure raised."""
        if tenant is None:
            self.router.drain(timeout=timeout)
            return
        for sid in self._shards_of(self._tname(tenant)):
            sh = self.router.shard(sid)
            if sh.engine is not None:
                sh.engine.drain(timeout=timeout)
            sh.log.drain(timeout=timeout)

    # -- consistent snapshot -------------------------------------------------- #
    def snapshot_view(self) -> Tuple[SnapshotCut,
                                     Dict[bytes, Dict[bytes, bytes]]]:
        """Coherent cross-tenant table state via the router's two-phase
        cut: tables are rebuilt by replaying each shard's cut prefix in
        LSN order (last-writer-wins within a shard = within a tenant's
        key, since a key always routes to one shard)."""
        cut = self.router.snapshot_cut()
        self.router.wait_cut_durable(cut)
        tables: Dict[bytes, Dict[bytes, bytes]] = {
            t: {} for t in self.tenants()}
        for _sid, _lsn, payload in self.router.cut_records(cut):
            t, k, v = decode_tenant_put(payload)
            tables.setdefault(t, {})[k] = v
        return cut, tables

    def checkpoint_and_trim(self) -> Tuple[SnapshotCut,
                                           Dict[bytes, Dict[bytes, bytes]],
                                           Dict[str, float]]:
        """Snapshot-then-truncate across every tenant (DESIGN.md §13):
        materialise a coherent table state via the two-phase cut, then
        bulk-truncate each shard up to its durable watermark in that
        cut.  Returns (cut, tables, per-shard trim vns).  The tables
        ARE the snapshot — the caller persists them; recovery overlays
        the surviving log suffix via ``recover_tables(logs, tables)``."""
        cut, tables = self.snapshot_view()
        trims = self.router.trim_to_cut(cut)
        return cut, tables, trims

    # -- tenant-scoped stats / faults ----------------------------------------- #
    def _check_owns(self, t: bytes, shard_id: str) -> None:
        if shard_id not in self._shards_of(t):
            raise PermissionError(
                f"tenant {t!r} does not own shard {shard_id!r}")

    def tenant_stats(self, tenant: Union[str, bytes]) -> dict:
        t = self._tname(tenant)
        full = self.router.stats()["shards"]
        per = {sid: full[sid] for sid in self._shards_of(t)}
        return dict(
            tenant=t.decode(), shards=per,
            records=sum(s["log"]["next_lsn"] - 1 for s in per.values()),
            appends=sum(s["router"]["appends"] for s in per.values()),
            bytes_in=sum(s["router"]["bytes_in"] for s in per.values()),
            engine_failed=sum(s["engine"]["failed"]
                              for s in per.values() if "engine" in s))

    def fail_backup(self, tenant: Union[str, bytes], shard_id: str,
                    server_id: str) -> None:
        t = self._tname(tenant)
        self._check_owns(t, shard_id)
        self.router.fail_backup(shard_id, server_id)

    def kill_backup_midwire(self, tenant: Union[str, bytes],
                            shard_id: str, server_id: str, **kw) -> None:
        t = self._tname(tenant)
        self._check_owns(t, shard_id)
        self.router.kill_backup_midwire(shard_id, server_id, **kw)

    # -- lifecycle ------------------------------------------------------------ #
    def close(self) -> None:
        self.router.shutdown()

    @staticmethod
    def recover_tables(logs: Dict[str, Log],
                       base_tables: Optional[
                           Dict[bytes, Dict[bytes, bytes]]] = None
                       ) -> Dict[bytes, Dict[bytes, bytes]]:
        """Rebuild per-tenant tables from recovered shard logs (e.g.
        ``LogRouter.recover().logs``) — the tenant id is in every
        payload, so no external metadata is needed.

        After a ``checkpoint_and_trim``, the logs hold only the suffix
        above each shard's trim watermark; pass the snapshot tables as
        ``base_tables`` and the tail is replayed OVER them (puts are
        last-writer-wins, so snapshot-then-overlay is exact)."""
        tables: Dict[bytes, Dict[bytes, bytes]] = {
            t: dict(kv) for t, kv in (base_tables or {}).items()}
        for log in logs.values():
            for _lsn, payload in log.iter_records():
                t, k, v = decode_tenant_put(payload)
                tables.setdefault(t, {})[k] = v
        return tables


class BaselineKV:
    """Same store over a baseline log (monolithic append only)."""

    def __init__(self, blog):
        self.blog = blog
        self._table: Dict[bytes, bytes] = {}
        self._lock = threading.Lock()

    def put(self, key: bytes, val: bytes) -> int:
        payload = encode_put(key, val)
        rid, _vns = self.blog.append(payload)
        with self._lock:
            self._table[key] = val
        return rid

    def put_many(self, items: Iterable[Tuple[bytes, bytes]]) -> List[int]:
        """Baseline batch path: per-record appends under the hood."""
        items = list(items)
        lsns, _vns = self.blog.append_batch(
            [encode_put(k, v) for k, v in items])
        with self._lock:
            for k, v in items:
                self._table[k] = v
        return lsns

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._table.get(key)

    @classmethod
    def recover(cls, blog) -> "BaselineKV":
        kv = cls(blog)
        for _, payload in blog.iter_records():
            k, v = decode_put(payload)
            kv._table[k] = v
        return kv
