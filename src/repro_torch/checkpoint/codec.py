"""Checkpoint shard codec: the integrity primitive applied to tensors.

A shard is one chunk of one pytree leaf, serialized as

    | magic u32 | hdr_len u32 | header(json) | hdr_crc u32 | payload | crc u32 |

with the payload CRC seeded by the header CRC (same fix as the log's
record CRC: a torn/zeroed shard can never validate as an empty one).
Exactly Listing 1's layout, so a torn object-store write or a silent
media error is *detected at read time* with no ordering requirements on
the writer — which is what lets checkpoint shard writes proceed fully
concurrently (the `copy` stage of the checkpoint write path).

The JAX package's codec, byte for byte.  numpy has no bfloat16 of its
own, so a bf16 shard (header dtype "bfloat16", as the JAX package writes
it) travels here as its raw 16-bit words: ``encode_shard`` takes them as
a uint16 array and ``decode_shard`` returns them so (``storage_dtype``).
``decode_shard``'s array is a read-only view of the shard's payload in
``raw``, not a copy of it.
"""

from __future__ import annotations

import json
import struct
import zlib
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np

MAGIC = 0xC4EC_0001
_U32 = struct.Struct("<I")


class ShardCorruptError(Exception):
    pass


@dataclass
class ShardMeta:
    key: str
    step: int
    dtype: str
    shape: Tuple[int, ...]
    chunk_index: int          # position along axis 0
    n_chunks: int
    global_shape: Tuple[int, ...]

    def to_json(self) -> Dict[str, Any]:
        return dict(key=self.key, step=self.step, dtype=self.dtype,
                    shape=list(self.shape), chunk_index=self.chunk_index,
                    n_chunks=self.n_chunks,
                    global_shape=list(self.global_shape))

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "ShardMeta":
        return cls(key=d["key"], step=int(d["step"]), dtype=d["dtype"],
                   shape=tuple(d["shape"]),
                   chunk_index=int(d["chunk_index"]),
                   n_chunks=int(d["n_chunks"]),
                   global_shape=tuple(d["global_shape"]))


def encode_shard(arr: np.ndarray, meta: ShardMeta) -> bytes:
    header = json.dumps(meta.to_json(), separators=(",", ":")).encode()
    payload = np.ascontiguousarray(arr).tobytes()
    hdr_crc = zlib.crc32(header, zlib.crc32(_U32.pack(len(payload))))
    body_crc = zlib.crc32(payload, hdr_crc)   # seeded: covers header too
    return b"".join([
        _U32.pack(MAGIC), _U32.pack(len(header)), header,
        _U32.pack(hdr_crc), _U32.pack(len(payload)), payload,
        _U32.pack(body_crc),
    ])


def decode_shard(raw: bytes) -> Tuple[np.ndarray, ShardMeta]:
    try:
        (magic,) = _U32.unpack_from(raw, 0)
        if magic != MAGIC:
            raise ShardCorruptError("bad magic")
        (hlen,) = _U32.unpack_from(raw, 4)
        header = raw[8 : 8 + hlen]
        (hcrc,) = _U32.unpack_from(raw, 8 + hlen)
        (plen,) = _U32.unpack_from(raw, 12 + hlen)
        if zlib.crc32(header, zlib.crc32(_U32.pack(plen))) != hcrc:
            raise ShardCorruptError("header CRC mismatch")
        payload = memoryview(raw)[16 + hlen : 16 + hlen + plen]   # no copy
        (pcrc,) = _U32.unpack_from(raw, 16 + hlen + plen)
        if zlib.crc32(payload, hcrc) != pcrc:
            raise ShardCorruptError("payload CRC mismatch")
    except (struct.error, IndexError) as e:
        raise ShardCorruptError(f"truncated shard: {e}") from e
    meta = ShardMeta.from_json(json.loads(header.decode()))
    arr = np.frombuffer(payload, dtype=storage_dtype(meta.dtype)
                        ).reshape(meta.shape)
    return arr, meta


def storage_dtype(name: str) -> np.dtype:
    """The numpy dtype a shard of dtype ``name`` is held in (bf16 as its
    uint16 words)."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def shard_checksum(raw: bytes) -> int:
    """Whole-object checksum recorded in the manifest (end-to-end check)."""
    return zlib.crc32(raw)
