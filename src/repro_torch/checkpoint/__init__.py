"""Log-backed distributed checkpointing over the port's Arcadia log.  See
manager.py for the write-path mapping onto reserve/copy/complete/force."""

from .codec import (ShardCorruptError, ShardMeta, decode_shard, encode_shard,
                    shard_checksum)
from .manager import (CheckpointConfig, CheckpointManager, JOURNAL_TAG,
                      MANIFEST_TAG)
from .store import FileStore, ObjectStore, ReplicatedStore, StoreError

__all__ = [
    "ShardCorruptError", "ShardMeta", "decode_shard", "encode_shard",
    "shard_checksum", "CheckpointConfig", "CheckpointManager",
    "JOURNAL_TAG", "MANIFEST_TAG", "FileStore", "ObjectStore",
    "ReplicatedStore", "StoreError",
]
