"""Quorum recovery protocol (§4.2).

On (re)start the newly elected primary:

  1. reads the superline from every reachable copy; at least a *read
     quorum* R = N - W + 1 of copies must be readable, else recovery
     fails (caller retries when more backups come online);
  2. computes max epoch over readable copies; copies at a lower epoch are
     *invalid* (they diverged during an earlier partial-failure window —
     the paper's A/B/C example);
  3. among valid copies, picks the one with the longest valid record
     chain (superline + scan identify the most recent data);
  4. repairs every other reachable copy from the chosen one (idempotent:
     only differing bytes are rewritten, so repeated recovery failures
     are safe);
  5. bumps the epoch by 1 and writes it to all reachable copies; a write
     quorum of epoch writes must succeed;
  6. returns an open ``Log`` on the recovered primary copy.

Copies are addressed through ``CopyAccessor`` so the same protocol runs
over a local device, an RDMA transport, or (in tests) a dead node's
surviving media image.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .log import (CorruptLogError, Log, LogConfig, Superline,
                  resolve_device, ring_offset, superline_region)
from .pmem import CACHE_LINE, PMEMDevice
from .transport import (QuorumError, ReplicaServer, ReplicationGroup,
                        Transport, TransportError)

# The exceptions a replica access is allowed to fail with during recovery:
# transport timeouts/partitions/fencing, OS-level media errors, and
# out-of-bounds device access (a copy with the wrong geometry).  Anything
# else is a programming error and must propagate.
MEDIA_ERRORS = (TransportError, OSError, ValueError)

# Repair diff granularity: a whole number of cache lines (the media's
# natural write unit), so each shipped range is cache-line-aligned within
# its region.  §4.2's idempotence argument ("only differing bytes are
# rewritten") binds repair cost to divergence size, not image size.
REPAIR_CHUNK = 16 * CACHE_LINE


class RecoveryError(Exception):
    pass


@dataclass
class CopyAccessor:
    """Uniform byte-level access to one replica's log media."""

    name: str
    size: int
    read: Callable[[int, int], bytes]          # (off, n) -> bytes
    write: Callable[[int, bytes], None]        # (off, data) -> durable write

    @classmethod
    def for_device(cls, name: str, dev: PMEMDevice) -> "CopyAccessor":
        def _write(off: int, data: bytes) -> None:
            dev.write(off, data)
            dev.persist(off, len(data))
        return cls(name=name, size=dev.size,
                   read=lambda off, n: dev.read(off, n), write=_write)

    @classmethod
    def for_transport(cls, t: Transport) -> "CopyAccessor":
        def _read(off: int, n: int) -> bytes:
            data, _ = t.read(off, n)
            return data
        def _write(off: int, data: bytes) -> None:
            t.write_imm_bytes(data, off)
        return cls(name=t.server.server_id, size=t.server.device.size,
                   read=_read, write=_write)


@dataclass
class CopyState:
    acc: CopyAccessor
    image: Optional[PMEMDevice] = None       # local scratch reconstruction
    raw: Optional[torch.Tensor] = None       # pristine wire image (pre-stamp)
    superline: Optional[Superline] = None
    last_lsn: int = -1
    readable: bool = False
    error: str = ""


@dataclass
class RecoveryReport:
    n_copies: int
    n_readable: int
    read_quorum: int
    old_epoch: int
    new_epoch: int
    chosen: str = ""
    repaired: List[str] = field(default_factory=list)
    repair_bytes: Dict[str, int] = field(default_factory=dict)
    last_lsn: int = 0


def _u8(raw: bytes) -> torch.Tensor:
    """A CPU uint8 tensor holding a copy of ``raw``."""
    out = torch.empty(len(raw), dtype=torch.uint8)
    out.numpy()[:] = memoryview(raw).cast("B")
    return out


def _load_copy(acc: CopyAccessor, cfg: LogConfig,
               device: torch.device) -> CopyState:
    """Pull a replica's media into a scratch device in ONE bulk read and
    validate it; the pristine bytes are kept for the repair diff."""
    st = CopyState(acc=acc)
    try:
        raw = acc.read(0, ring_offset() + cfg.capacity)
    except MEDIA_ERRORS as e:  # unreachable / media gone
        st.error = f"unreachable: {e}"
        return st
    st.raw = _u8(raw)
    img = PMEMDevice(acc.size, mode="fast", name=f"scratch/{acc.name}")
    img.write(0, raw)
    img.persist(0, len(raw))
    st.image = img
    try:
        log = Log.open(img, LogConfig(capacity=cfg.capacity), device=device)
    except CorruptLogError as e:
        st.error = f"corrupt: {e}"
        return st
    st.superline = log.read_superline()
    st.last_lsn = log.next_lsn - 1
    st.readable = st.superline is not None
    return st


def _diff_ranges(golden: torch.Tensor, current: torch.Tensor, base: int,
                 chunk: int = REPAIR_CHUNK) -> List[Tuple[int, int]]:
    """Coalesced [start, end) byte ranges (offset by ``base``) where
    ``current`` differs from ``golden``, on chunk-aligned boundaries.

    One vectorized compare over the region, one any() reduction per
    chunk, adjacent dirty chunks merged — the repair fan-out ships these
    ranges instead of the whole image.
    """
    n = golden.numel()
    if n == 0:
        return []
    neq = golden != current
    nchunks = -(-n // chunk)
    pad = nchunks * chunk - n
    if pad:
        neq = torch.cat([neq, neq.new_zeros(pad)])
    dirty = torch.nonzero(neq.view(nchunks, chunk).any(dim=1)).flatten()
    if dirty.numel() == 0:
        return []
    # runs of adjacent dirty chunks: a run starts where the gap to the
    # previous dirty chunk exceeds one
    gap = torch.diff(dirty) > 1
    starts = torch.cat([dirty[:1], dirty[1:][gap]]).tolist()
    ends = torch.cat([dirty[:-1][gap], dirty[-1:]]).tolist()
    return [(base + a * chunk, base + min((b + 1) * chunk, n))
            for a, b in zip(starts, ends)]


def quorum_recover(
    accessors: List[CopyAccessor],
    cfg: LogConfig,
    write_quorum: int,
    local_name: Optional[str] = None,
    device="cuda",
) -> Tuple[Optional[PMEMDevice], RecoveryReport]:
    """Run the §4.2 protocol over the reachable copies.

    Returns (recovered_primary_image | None, report).  The image is a
    repaired media image for the copy named ``local_name`` (or the chosen
    copy); the caller opens a Log over it / adopts it as its device.
    ``device`` is where the copies' integrity hashes are checked.
    """
    device = resolve_device(device)
    n = len(accessors)
    read_quorum = n - write_quorum + 1
    states = [_load_copy(a, cfg, device) for a in accessors]
    readable = [s for s in states if s.readable]
    if len(readable) < read_quorum:
        bad = {s.acc.name: s.error for s in states if not s.readable}
        raise RecoveryError(
            f"read quorum not met: {len(readable)}/{n} readable "
            f"(need {read_quorum}); failures={bad}")

    old_epoch = max(s.superline.epoch for s in readable)
    new_epoch = old_epoch + 1
    # §4.2 Handling Diverging Histories: only max-epoch copies are valid
    valid = [s for s in readable if s.superline.epoch == old_epoch]
    best = max(valid, key=lambda s: (s.last_lsn, s.superline.head_lsn))

    report = RecoveryReport(n_copies=n, n_readable=len(readable),
                            read_quorum=read_quorum, old_epoch=old_epoch,
                            new_epoch=new_epoch, chosen=best.acc.name,
                            last_lsn=best.last_lsn)

    # stamp the new epoch on the chosen image before fan-out
    chosen_log = Log.open(best.image, LogConfig(capacity=cfg.capacity),
                          device=device)
    chosen_log._epoch = new_epoch
    chosen_log._write_superline()
    golden = best.image.read(0, ring_offset() + cfg.capacity)

    # repair: ship only the differing ranges (chunked diff against each
    # copy's pristine wire image — §4.2: "only differing bytes are
    # rewritten", which also makes repeated recovery attempts idempotent
    # and bounds repair traffic by divergence, not image size).
    golden_arr = _u8(golden)
    head_len = ring_offset()
    ok_writes = 0
    for s in states:
        try:
            if s.raw is None:
                # copy was never readable: rebuild it wholesale
                s.acc.write(0, golden)
                report.repaired.append(s.acc.name)
                report.repair_bytes[s.acc.name] = len(golden)
                ok_writes += 1
                continue
            # superline region diffed separately from the ring so the
            # (always-differing) epoch bump never drags ring chunks along
            ranges = _diff_ranges(golden_arr[:head_len], s.raw[:head_len], 0)
            ranges += _diff_ranges(golden_arr[head_len:], s.raw[head_len:],
                                   head_len)
            shipped = 0
            for a, b in ranges:
                s.acc.write(a, golden[a:b])
                shipped += b - a
            report.repair_bytes[s.acc.name] = shipped
            if any(b > head_len for _, b in ranges):   # ring bytes differed
                report.repaired.append(s.acc.name)
            ok_writes += 1
        except MEDIA_ERRORS:
            continue
    if ok_writes < write_quorum:
        raise RecoveryError(
            f"write quorum not met while publishing epoch {new_epoch}: "
            f"{ok_writes}/{n} (need {write_quorum})")

    primary_image = None
    if local_name is not None:
        for s in states:
            if s.acc.name == local_name:
                primary_image = s.image
        if primary_image is None:
            primary_image = PMEMDevice(best.acc.size, mode="fast",
                                       name=f"rebuilt/{local_name}")
    else:
        primary_image = best.image
    primary_image.write(0, golden)
    primary_image.persist(0, len(golden))
    return primary_image, report
