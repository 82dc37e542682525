"""Distributed checkpoint manager built on the Arcadia log.

The paper's write path, applied to training state:

  reserve   — allocate the manifest's LSN in the log: checkpoints of
              successive steps get monotonic LSNs, so commit order is
              total even with overlapping async saves.
  copy      — shard payload writes to the replicated object stores, fully
              concurrent across leaves/chunks/threads (integrity primitive
              per shard: no ordering or atomicity needed — §3).
  complete  — the manifest (shard keys + whole-object checksums + step +
              extra metadata) is written as the log record payload.
  force     — quorum-committed via the log with the *frequency-based force
              policy*: with frequency F and T concurrent save groups, at
              most F×T checkpoint commits can be lost on a crash (§4.4) —
              the knob that makes per-step journaling affordable.

Recovery = log recovery (quorum, epochs) + walking committed manifests
newest-first until one fully validates against the stores (read-repair
fixes straggler replicas).  Restore reassembles chunked leaves, so a
checkpoint written by N hosts restores onto M != N hosts (elastic).

The JAX package's manager over the port's ``Log``.  A state is a tree of
torch tensors and/or numpy arrays and scalars (``repro_torch.tree``),
walked in ``jax.tree_util``'s order with its leaf names, so shard keys
and manifests are the JAX package's byte for byte.  Restore gives each
leaf in the template's kind: a tensor on the template tensor's device
(a DTensor on the template's mesh and placements), or a numpy array.
"""

from __future__ import annotations

import json
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from ..core.log import Log, LogFullError
from ..trace import span
from ..tree import leaf_paths, map_with_path, tree_map
from .codec import (ShardCorruptError, ShardMeta, decode_shard, encode_shard,
                    shard_checksum)
from .store import ReplicatedStore

MANIFEST_TAG = b"CKPT"
JOURNAL_TAG = b"JRNL"


@dataclass
class CheckpointConfig:
    force_freq: int = 1          # F — manifest commit frequency
    writer_threads: int = 4      # concurrent shard writers ("copy" stage)
    chunks_per_leaf: int = 1     # axis-0 chunking (per-host shards)
    keep_last: int = 2           # GC horizon (committed checkpoints kept)


def _host_array(leaf) -> Tuple[np.ndarray, str]:
    """(host array, dtype name) of a leaf; a bf16 tensor gives its uint16
    words and the name "bfloat16" (what the JAX package records).  A
    DTensor leaf is gathered whole first (a collective: every rank of its
    mesh saves)."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _like(template, full: np.ndarray, dtype: str):
    """A restored leaf in the template leaf's kind; a DTensor template's
    mesh and placements lay it out (the elastic restore onto another
    mesh).  ``full`` is copied only when it is a read-only view of a
    shard (one chunk); chunks concatenated are a fresh array already."""
    if not isinstance(template, torch.Tensor):
        return full
    t = torch.from_numpy(full if full.flags.writeable else full.copy())
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    if isinstance(template, DTensor):
        mesh = template.device_mesh
        return distribute_tensor(t.to(mesh.device_type), mesh,
                                 template.placements)
    return t.to(template.device)


class CheckpointManager:
    def __init__(self, store: ReplicatedStore, log: Log,
                 cfg: Optional[CheckpointConfig] = None):
        self.store = store
        self.log = log
        self.cfg = cfg or CheckpointConfig()
        self._pool = ThreadPoolExecutor(
            max_workers=self.cfg.writer_threads, thread_name_prefix="ckpt")
        # async saves run on a dedicated single worker: manifests commit
        # in submission (step) order, and shard-put futures on _pool can
        # never be starved by a waiting save
        self._save_pool = ThreadPoolExecutor(max_workers=1,
                                             thread_name_prefix="ckpt-save")
        self._save_lock = threading.Lock()
        self._async: List[Future] = []
        self.snapshot_bytes = 0      # bytes save_async copied to the host
        self.snapshot_s = 0.0        # ... and the host seconds it took

    # ------------------------------------------------------------------ #
    # save path
    # ------------------------------------------------------------------ #
    def _chunk(self, arr: np.ndarray) -> List[np.ndarray]:
        c = self.cfg.chunks_per_leaf
        if c <= 1 or arr.ndim == 0 or arr.shape[0] < c:
            return [arr]
        return np.array_split(arr, c, axis=0)

    def save(self, step: int, state, extra: Optional[Dict[str, Any]] = None,
             sync: bool = False) -> int:
        """Write one checkpoint; returns the manifest's LSN.

        ``sync=True`` forces with freq=1 (explicit durability guarantee —
        the paper's transaction-commit use case); otherwise the configured
        frequency policy amortizes the force.
        """
        entries: List[Dict[str, Any]] = []
        futs = []
        for path, leaf in leaf_paths(state):
            arr, dtype = _host_array(leaf)
            chunks = self._chunk(arr)
            for ci, chunk in enumerate(chunks):
                key = f"step{step:012d}{path}/c{ci}of{len(chunks)}"
                meta = ShardMeta(key=key, step=step, dtype=dtype,
                                 shape=tuple(chunk.shape), chunk_index=ci,
                                 n_chunks=len(chunks),
                                 global_shape=tuple(arr.shape))
                futs.append(self._pool.submit(self._put_shard, key, chunk,
                                              meta))
            entries.append(dict(path=path, dtype=dtype,
                                shape=list(arr.shape), n_chunks=len(chunks)))
        checksums = {}
        for f in futs:                     # all shards durable before commit
            key, csum = f.result()
            checksums[key] = csum
        manifest = dict(step=step, entries=entries, checksums=checksums,
                        extra=extra or {})
        payload = MANIFEST_TAG + json.dumps(manifest).encode()
        with span("ckpt.manifest"):
            with self._save_lock:          # manifests commit in step order
                rid, view = self.log.reserve(len(payload))
                if view is not None:
                    view[:] = payload
                else:
                    self.log.copy(rid, payload)
                self.log.complete(rid)
            self.log.force(rid, freq=1 if sync else self.cfg.force_freq)
        return rid

    def save_async(self, step: int, state,
                   extra: Optional[Dict[str, Any]] = None) -> Future:
        """Overlap checkpointing with training compute.  The dedicated
        save worker serializes saves, so manifests commit in step order
        (the log's in-order-commit invariant extended to checkpoints);
        shard writes within each save still fan out over _pool."""
        t = time.perf_counter()
        with span("ckpt.snapshot"):
            state = _snapshot(state)
        self.snapshot_s += time.perf_counter() - t
        self.snapshot_bytes += sum(leaf.nbytes for _, leaf in
                                   leaf_paths(state))
        fut = self._save_pool.submit(self.save, step, state, extra)
        self._async.append(fut)
        return fut

    def wait(self) -> None:
        for f in self._async:
            f.result()
        self._async.clear()

    def _put_shard(self, key: str, chunk: np.ndarray, meta: ShardMeta
                   ) -> Tuple[str, int]:
        with span("ckpt.encode"):
            raw = encode_shard(chunk, meta)
        with span("ckpt.put"):
            self.store.put(key, raw)
        return key, shard_checksum(raw)

    def stats(self) -> dict:
        """The snapshot counters: bytes ``save_async`` copied to the host
        and the host seconds it took, over the manager's life."""
        return dict(snapshot_bytes=self.snapshot_bytes,
                    snapshot_s=self.snapshot_s)

    # ------------------------------------------------------------------ #
    # journal records (same log, same policy)
    # ------------------------------------------------------------------ #
    def journal(self, record: Dict[str, Any], sync: bool = False) -> int:
        payload = JOURNAL_TAG + json.dumps(record).encode()
        rid = self.log.append(payload,
                              freq=1 if sync else self.cfg.force_freq)
        return rid

    # ------------------------------------------------------------------ #
    # restore path
    # ------------------------------------------------------------------ #
    def manifests(self) -> List[Tuple[int, Dict[str, Any]]]:
        """(lsn, manifest) for every committed manifest, oldest first."""
        out = []
        for lsn, payload in self.log.iter_records():
            if payload[:4] == MANIFEST_TAG:
                out.append((lsn, json.loads(payload[4:].decode())))
        return out

    def journal_records(self) -> List[Tuple[int, Dict[str, Any]]]:
        return [(lsn, json.loads(p[4:].decode()))
                for lsn, p in self.log.iter_records()
                if p[:4] == JOURNAL_TAG]

    def latest_step(self) -> Optional[int]:
        ms = self.manifests()
        return ms[-1][1]["step"] if ms else None

    def restore(self, template, step: Optional[int] = None
                ) -> Tuple[int, Any, Dict[str, Any]]:
        """Restore the newest (or requested) checkpoint that fully
        validates.  Falls back to older checkpoints if shards of the
        newest are unrecoverable on every replica."""
        cands = self.manifests()
        if step is not None:
            cands = [(l, m) for l, m in cands if m["step"] == step]
        if not cands:
            raise FileNotFoundError("no committed checkpoint manifest found")
        last_err: Optional[Exception] = None
        for lsn, manifest in reversed(cands):
            try:
                state = self._materialize(template, manifest)
                return manifest["step"], state, manifest.get("extra", {})
            except (ShardCorruptError, KeyError) as e:
                last_err = e               # try the previous checkpoint
        raise ShardCorruptError(
            f"no restorable checkpoint (last error: {last_err})")

    def _materialize(self, template, manifest: Dict[str, Any]):
        step = manifest["step"]
        by_path = {e["path"]: e for e in manifest["entries"]}
        values = {}
        for p, tleaf in leaf_paths(template):
            if p not in by_path:
                raise KeyError(f"leaf {p} missing from manifest")
            e = by_path[p]
            chunks = []
            for ci in range(e["n_chunks"]):
                key = f"step{step:012d}{p}/c{ci}of{e['n_chunks']}"
                raw = self.store.get(
                    key, expect_checksum=manifest["checksums"].get(key))
                arr, meta = decode_shard(raw)
                chunks.append(arr)
            full = chunks[0] if len(chunks) == 1 else \
                np.concatenate(chunks, axis=0)
            expect_shape = tuple(e["shape"])
            if tuple(full.shape) != expect_shape:
                raise ShardCorruptError(
                    f"{p}: reassembled {full.shape} != {expect_shape}")
            t_shape = tuple(tleaf.shape) if hasattr(tleaf, "shape") \
                else tuple(np.asarray(tleaf).shape)
            if t_shape != expect_shape:
                raise ValueError(
                    f"{p}: template shape {t_shape} != stored {expect_shape}")
            values[p] = _like(tleaf, full, e["dtype"])
        return map_with_path(lambda p, _: values[p], template)

    # ------------------------------------------------------------------ #
    # space management (log reclamation + shard GC)
    # ------------------------------------------------------------------ #
    def gc(self, trim: bool = True) -> int:
        """Drop committed checkpoints beyond keep_last: delete their
        shards, then reclaim their log space.

        With ``trim=True`` (default) the log is bulk-truncated up to
        (not including) the oldest KEPT manifest via the durable trim
        watermark (DESIGN.md §13) — checkpoint GC and log truncation
        advance together, and journal records below the kept snapshot
        (superseded by it: restore replays the journal only from the
        restored step forward) are reclaimed in the same O(1) cut.
        ``trim=False`` keeps the legacy per-record tombstone walk over
        the victim manifests only."""
        ms = [(l, m) for l, m in self.manifests()
              if l <= self.log.durable_lsn]
        victims = ms[:-self.cfg.keep_last] if self.cfg.keep_last else ms
        removed = 0
        for lsn, manifest in victims:
            for key in manifest["checksums"]:
                self.store.delete(key)
            removed += 1
        if trim:
            # trimming below the oldest KEPT manifest is legal even with
            # zero victims (records there are superseded by it) — the
            # very first checkpoint already frees the ring behind it
            kept = ms[len(victims):]
            if kept:
                self.log.trim(kept[0][0] - 1)
            elif victims:
                self.log.trim(victims[-1][0])
        else:
            for lsn, _ in victims:
                self.log.cleanup(lsn)
        return removed

    def close(self) -> None:
        self.wait()
        self._save_pool.shutdown(wait=True)
        self._pool.shutdown(wait=True)


def _snapshot(tree):
    """Copy leaves to host so async saves see a stable image, each once:
    ``.cpu()`` of a card's tensor is already a copy, and only a tensor it
    returns as is (one on the host) is cloned."""
    def copy(x):
        if not isinstance(x, torch.Tensor):
            return np.array(x)
        t = x.detach()
        host = t.cpu()
        return host.clone() if host is t else host
    return tree_map(copy, tree)
