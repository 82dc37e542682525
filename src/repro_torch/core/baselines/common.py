"""Shared baseline plumbing."""

from __future__ import annotations

from typing import List, Tuple


def append_batch_looped(blog, payloads: List[bytes]) -> Tuple[List[int], float]:
    """Batch-axis shim for the baseline logs: none of them has a batched
    append, so the batch API is the per-record path in a loop — each
    record still pays its design's full persist/fence bill, which is the
    fair Fig. 5 contrast against Arcadia's coalesced pipeline."""
    lsns, vns = [], 0.0
    for data in payloads:
        lsn, v = blog.append(data)
        lsns.append(lsn)
        vns += v
    return lsns, vns
