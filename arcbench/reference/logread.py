"""Journal records read back from a durable image of the log, plainly.

A record on the media is

    lsn u64 | size u32 | crc u32 | flags u64 | payload (size bytes) | pad8

(little-endian, records 8-byte aligned); a valid record has flag bit 0
set, and its crc is CRC32 of the payload seeded with the CRC32 of
(lsn u64, size u32).  A journal record's payload is ``JRNL`` followed by
its JSON.  The reader finds every ``JRNL`` payload at an 8-byte boundary
and keeps those whose header is valid and whose CRC holds.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Dict

HDR = struct.Struct("<QIIQ")
SEED = struct.Struct("<QI")
TAG = b"JRNL"
VALID = 1
PHASH = 1 << 3


def journal(image: bytes) -> Dict[int, dict]:
    """{lsn: record} of every valid journal record in ``image``."""
    out: Dict[int, dict] = {}
    at = image.find(TAG)
    while at >= 0:
        h = at - HDR.size
        if at % 8 == 0 and h >= 0:
            lsn, size, crc, flags = HDR.unpack_from(image, h)
            payload = image[at:at + size]
            if flags & VALID and not flags & PHASH and len(payload) == size \
                    and zlib.crc32(payload, zlib.crc32(SEED.pack(lsn, size))) \
                    == crc:
                try:
                    out[lsn] = json.loads(payload[len(TAG):].decode())
                except ValueError:
                    pass
        at = image.find(TAG, at + 1)
    return out


def missing(images, records) -> int:
    """How many (image, record) pairs fail: each of ``records`` has to be
    in every image, equal, once."""
    bad = 0
    for _, image in images:
        held = list(journal(image).values())
        for r in records:
            if held.count(r) != 1:
                bad += 1
    return bad
