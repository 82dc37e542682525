"""Simulated persistent-memory device with explicit volatility semantics.

The paper's correctness arguments all rest on three hardware facts about
PMEM (Optane DCPMM behind the x86 cache hierarchy):

  1. Stores are *volatile* until the cache line has been written back
     (clwb/clflushopt) and a fence has retired (sfence).
  2. Persistence granularity/atomicity is 8 bytes: on power loss an
     in-flight cache-line writeback may tear at any 8-byte boundary, and
     dirty lines may reach the media in *any order* (implicit evictions).
  3. Media errors / stray writes can silently corrupt persisted bytes.

``PMEMDevice`` models exactly these semantics so crash-consistency can be
*property-tested* rather than asserted.  Two modes:

  * ``strict``  — full volatile-overlay model at 8-byte granularity.
                  ``crash()`` keeps an arbitrary subset of unflushed units
                  (torn + reordered writes).  Used by correctness tests.
  * ``fast``    — writes go straight to the durable buffer (a
                  write-through view of the same semantics: everything a
                  crash *may* persist).  Used by benchmarks where we
                  measure real software cost (copies, checksums, locking).

The strict model is vectorized (DESIGN.md §1): instead of a dict of
8-byte unit blobs and Python sets of line numbers, the device keeps

  * ``_durable``  — a full-size uint8 tensor, what survives power loss,
  * ``_overlay``  — a full-size uint8 tensor holding the newest (not yet
                    persisted) bytes; only valid where ``_dirty`` is set,
  * ``_dirty``    — one bool per 8-byte unit (the torn-write granule),
  * ``_resident`` — one bool per cache line (the Fig. 6 LLC model),

so ``write``/``read``/``persist``/``crash`` are slice assignments and
boolean-mask copies.  All four are CPU torch tensors: in the modelled
system PMEM is host-attached memory behind the CPU caches, so the images
stay in host memory and only the integrity hashing goes to the card.
Byte-level I/O with Python buffers goes through the tensors' numpy views,
which share their memory.  A dirty unit's overlay content is always the *full*
unit (partial stores are seeded from the durable image first), which is
what makes ``crash()`` an independent keep/drop draw per unit — the same
torn/reordered semantics the scalar model realized one dict entry at a
time.

Because this container has no Optane or RDMA NIC, hardware wait times are
accounted in *virtual nanoseconds* via ``CostModel``: every operation
returns the modelled ns it would take on the paper's testbed (Cascade
Lake + DCPMM + EDR InfiniBand).  Real compute (memcpy, CRC) is measured
with the wall clock and folded into the same figure.  Benchmarks report
both clocks; see DESIGN.md §2.3.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

CACHE_LINE = 64  # bytes, x86
ATOM = 8         # PMEM atomic persist unit, bytes


@dataclass
class CostModel:
    """Virtual-time constants, calibrated to the paper's testbed numbers.

    Defaults give: 1KB local persist ~ 1.1us, 1KB replicated write ~ 4.5us
    (one round trip), matching the magnitudes in Fig. 5b / Fig. 6.

    These constants price individual operations; *composition* of the
    prices into modelled latency is the virtual-timeline engine's job
    (``timeline.VirtualTimeline``, DESIGN.md §14): overlapped durability
    rounds are laid out on per-resource clocks, so the modelled time of
    a pipelined run is a timeline max, not a serial sum of these costs.
    DeviceStats counters are independent of the constants — swapping a
    cost model never moves a pinned hardware-event count or digest.
    """

    fence_ns: float = 100.0           # sfence drain
    line_writeback_ns: float = 60.0   # clwb per dirty line (async, overlapped)
    store_byte_ns: float = 0.12       # ntstore bandwidth ~ 8 GB/s
    pmem_read_byte_ns: float = 0.06   # PMEM read bandwidth ~ 16 GB/s
    rdma_rtt_ns: float = 3000.0       # EDR IB small-message round trip
    rdma_byte_ns: float = 0.085       # ~ 11.7 GB/s effective wire bandwidth
    llc_miss_ns: float = 80.0         # NIC DMA read that misses LLC (per line)
    crc_byte_ns: float = 0.25         # crc32 software cost (accounted, not spun)
    doorbell_ns: float = 150.0        # WQE post + doorbell ring (issue gap)

    def with_wire_rtt(self, rtt_ns: float) -> "CostModel":
        """This model with a different wire round trip — the what-if
        knob the timeline engine makes meaningful: a far-memory / CXL
        fabric (PAPERS.md, "Rethinking PM Crash Consistency in the CXL
        Era") or an injected-latency testbed is the same hardware with a
        slower wire, and only the modelled *time* should move, never the
        DeviceStats.  fig6 uses this to model its injected wall-clock
        RTT honestly instead of pricing a 4 ms stall at 3 us."""
        from dataclasses import replace
        return replace(self, rdma_rtt_ns=float(rtt_ns))


@dataclass
class DeviceStats:
    """Observable hardware-event counters (the paper reads these via PCM)."""

    writes: int = 0
    bytes_written: int = 0
    flushes: int = 0
    lines_flushed: int = 0
    fences: int = 0
    llc_misses: int = 0          # lines read by DMA that were not cache-resident
    llc_hits: int = 0
    media_errors_injected: int = 0

    def snapshot(self) -> "DeviceStats":
        return DeviceStats(**self.__dict__)


class PMEMDevice:
    """A byte-addressable persistent memory device (one DAX-mapped file)."""

    def __init__(
        self,
        size: int,
        mode: str = "fast",
        cost: Optional[CostModel] = None,
        name: str = "pmem0",
    ):
        if mode not in ("fast", "strict"):
            raise ValueError(f"unknown mode {mode!r}")
        self.size = int(size)
        self.mode = mode
        self.cost = cost or CostModel()
        self.name = name
        self.stats = DeviceStats()
        self._lock = threading.Lock()
        # Durable image: what survives power loss *for sure*.
        self._durable = torch.zeros(self.size, dtype=torch.uint8)
        self._durable_np = self._durable.numpy()      # shares memory
        self._n_units = (self.size + ATOM - 1) // ATOM
        self._n_lines = (self.size + CACHE_LINE - 1) // CACHE_LINE
        # Cache-residency of lines (True while dirty in LLC).  Used for the
        # Fig. 6 effect: flushing evicts lines, so a subsequent NIC DMA read
        # misses LLC and must re-read from PMEM.  (clwb was implemented as an
        # evicting flush on the paper's CPUs — footnote 5.)
        self._resident = torch.zeros(self._n_lines, dtype=torch.bool)
        self._resident_np = self._resident.numpy()
        if mode == "strict":
            # Volatile overlay: newest bytes, valid only where _dirty is set.
            self._overlay = torch.zeros(self.size, dtype=torch.uint8)
            self._overlay_np = self._overlay.numpy()
            self._dirty = torch.zeros(self._n_units, dtype=torch.bool)
            self._dirty_np = self._dirty.numpy()
        else:
            self._overlay = None
            self._overlay_np = None
            self._dirty = None
            self._dirty_np = None
        self._dirty_count = 0

    # ------------------------------------------------------------------ #
    # state carried between packages
    # ------------------------------------------------------------------ #
    @classmethod
    def from_numpy(cls, durable: np.ndarray, *, mode: str,
                   overlay: Optional[np.ndarray] = None,
                   dirty: Optional[np.ndarray] = None,
                   resident: Optional[np.ndarray] = None,
                   stats: Optional[dict] = None) -> "PMEMDevice":
        """A device holding the given image and counters: ``durable`` (and,
        in strict mode, ``overlay``/``dirty``) as uint8/bool numpy arrays,
        ``resident`` one bool per cache line, ``stats`` a dict of
        ``DeviceStats`` fields.  The arrays are copied."""
        durable = np.asarray(durable, dtype=np.uint8).reshape(-1)
        dev = cls(durable.size, mode=mode)
        dev._durable_np[:] = durable
        if resident is not None:
            dev._resident.numpy()[:] = np.asarray(resident, dtype=bool)
        if mode == "strict":
            if overlay is not None:
                dev._overlay_np[:] = np.asarray(overlay, dtype=np.uint8)
            if dirty is not None:
                dev._dirty.numpy()[:] = np.asarray(dirty, dtype=bool)
                dev._dirty_count = int(dev._dirty.count_nonzero())
        elif (dirty is not None and np.any(dirty)):
            raise ValueError("a fast-mode device holds no volatile overlay")
        if stats is not None:
            dev.stats = DeviceStats(**stats)
        return dev

    def to_numpy(self) -> dict:
        """Copies of the image and counters, in ``from_numpy``'s keys."""
        with self._lock:
            strict = self.mode == "strict"
            return dict(
                durable=self._durable_np.copy(),
                overlay=self._overlay_np.copy() if strict else None,
                dirty=self._dirty.numpy().copy() if strict else None,
                resident=self._resident.numpy().copy(),
                stats=dict(self.stats.__dict__))

    # ------------------------------------------------------------------ #
    # store / load
    # ------------------------------------------------------------------ #
    def write(self, off: int, data: bytes | bytearray | memoryview | np.ndarray) -> float:
        """CPU stores to [off, off+len). Volatile until persisted. Returns vns."""
        arr = _as_array(data)
        n = arr.size
        self._check(off, n)
        if n == 0:
            with self._lock:
                self.stats.writes += 1
            return 0.0
        if self.mode == "fast":
            self._durable_np[off : off + n] = arr
            with self._lock:
                self.stats.writes += 1
                self.stats.bytes_written += n
                self._resident_np[off // CACHE_LINE : (off + n - 1) // CACHE_LINE + 1] = True
        else:
            with self._lock:
                self._write_strict_locked(off, arr)
                self.stats.writes += 1
                self.stats.bytes_written += n
                self._resident_np[off // CACHE_LINE : (off + n - 1) // CACHE_LINE + 1] = True
        return self.cost.store_byte_ns * n

    def _write_strict_locked(self, off: int, arr: np.ndarray) -> None:
        """Store into the overlay at 8-byte-unit granularity.

        Boundary units that the store only partially covers are seeded
        from the newest visible content first, so every dirty unit's
        overlay slice is the complete unit — the invariant ``crash()``
        and ``persist()`` rely on.  Stores, loads and flushes touch a few
        units at a time, so they work on the tensors' numpy views (one
        torch operator call costs more than the whole numpy update, and
        under many producer threads the gap widens).
        """
        n = arr.size
        u0 = off // ATOM
        u1 = (off + n - 1) // ATOM + 1
        dirty = self._dirty_np
        if off % ATOM and not dirty[u0]:
            s = u0 * ATOM
            e = min(s + ATOM, self.size)
            self._overlay_np[s:e] = self._durable_np[s:e]
        if (off + n) % ATOM and not dirty[u1 - 1]:
            s = (u1 - 1) * ATOM
            e = min(s + ATOM, self.size)
            self._overlay_np[s:e] = self._durable_np[s:e]
        self._overlay_np[off : off + n] = arr
        dslice = dirty[u0:u1]
        self._dirty_count += int(dslice.size - np.count_nonzero(dslice))
        dslice[:] = True

    def read_tensor(self, off: int, n: int) -> torch.Tensor:
        """CPU load into a fresh uint8 tensor: sees the newest
        (volatile-overlaid) data."""
        return torch.from_numpy(self._read_np(off, n))

    def _read_np(self, off: int, n: int) -> np.ndarray:
        """The newest bytes of [off, off+n) as a fresh uint8 array."""
        self._check(off, n)
        if self.mode == "fast" or self._dirty_count == 0 or n == 0:
            return self._durable_np[off : off + n].copy()
        with self._lock:
            u0 = off // ATOM
            u1 = (off + n - 1) // ATOM + 1
            dslice = self._dirty_np[u0:u1]
            out = self._durable_np[off : off + n].copy()
            if dslice.any():
                s = off - u0 * ATOM
                mask = np.repeat(dslice, ATOM)[s : s + n]
                np.copyto(out, self._overlay_np[off : off + n], where=mask)
            return out

    def read(self, off: int, n: int) -> bytes:
        """CPU load: sees the newest (volatile-overlaid) data."""
        if self.mode == "fast" or self._dirty_count == 0:
            self._check(off, n)
            return self._durable_np[off : off + n].tobytes()
        return self._read_np(off, n).tobytes()

    def view(self, off: int, n: int) -> Optional[memoryview]:
        """Direct load/store pointer into PMEM (the paper's reserve() returns
        one).  Only available in fast mode; strict mode callers fall back to
        ``write``/``read`` so the volatility model stays sound."""
        self._check(off, n)
        if self.mode == "fast":
            return self._durable_np[off : off + n].data
        return None

    # ------------------------------------------------------------------ #
    # persistence primitive (clwb loop + sfence)
    # ------------------------------------------------------------------ #
    def persist(self, off: int, n: int) -> float:
        """Guarantee [off, off+n) is durable.  Returns vns (writeback+fence).

        Evicts the lines from the cache model (see _resident note).  Every
        8-byte unit *overlapping* the range is persisted whole (a clwb
        flushes full lines; the scalar model did the same).
        """
        self._check(off, n)
        with self._lock:
            if self.mode == "strict" and n > 0 and self._dirty_count:
                u0 = off // ATOM
                u1 = (off + n - 1) // ATOM + 1
                dslice = self._dirty_np[u0:u1]
                ndirty = int(np.count_nonzero(dslice))
                if ndirty:
                    s = u0 * ATOM
                    e = min(u1 * ATOM, self.size)
                    mask = np.repeat(dslice, ATOM)[: e - s]
                    np.copyto(self._durable_np[s:e], self._overlay_np[s:e],
                              where=mask)
                    self._dirty_count -= ndirty
                    dslice[:] = False
            if n > 0:
                l0 = off // CACHE_LINE
                l1 = (off + n - 1) // CACHE_LINE + 1
                rslice = self._resident_np[l0:l1]
                dirty_lines = int(np.count_nonzero(rslice))
                rslice[:] = False
            else:
                dirty_lines = 0
            self.stats.flushes += 1
            self.stats.lines_flushed += dirty_lines
            self.stats.fences += 1
        # clwb writebacks overlap; fence waits for the slowest. Model as
        # per-line issue cost + one fence drain.
        return self.cost.line_writeback_ns * max(dirty_lines, 1) + self.cost.fence_ns

    def dma_read(self, off: int, n: int) -> tuple[bytes, float]:
        """Device-side (NIC) read of the *newest* data, as an RDMA HCA would
        snoop it.  Cost depends on LLC residency: lines evicted by a prior
        flush must be re-read from PMEM (the Fig. 6 effect)."""
        data = self.read(off, n)
        with self._lock:
            if n > 0:
                l0 = off // CACHE_LINE
                l1 = (off + n - 1) // CACHE_LINE + 1
                n_lines = l1 - l0
                hit = int(np.count_nonzero(self._resident_np[l0:l1]))
                miss = n_lines - hit
            else:
                n_lines = hit = miss = 0
            self.stats.llc_misses += miss
            self.stats.llc_hits += hit
        vns = miss * self.cost.llc_miss_ns + n * self.cost.pmem_read_byte_ns * (
            miss / max(n_lines, 1)
        )
        return data, vns

    # ------------------------------------------------------------------ #
    # failure injection
    # ------------------------------------------------------------------ #
    def crash(self, rng: Optional[np.random.Generator] = None,
              keep_probability: float = 0.5) -> "PMEMDevice":
        """Power loss.  Returns the device as found at next boot.

        Every unflushed 8-byte unit independently either reached the media
        (implicit eviction happened before the crash) or is lost — this
        realizes both *torn writes* (a record's units split) and *reordered
        persistence* (later stores survive while earlier ones vanish).
        The keep/drop draws come from the numpy ``rng``, one per dirty
        unit in ascending unit order, so a seeded schedule keeps the same
        units as the JAX package's device does.
        """
        rng = rng or np.random.default_rng(0)
        survivor = PMEMDevice(self.size, mode=self.mode, cost=self.cost,
                              name=self.name)
        with self._lock:
            survivor._durable.copy_(self._durable)
            if self.mode == "strict" and self._dirty_count:
                units = torch.nonzero(self._dirty).flatten()
                keep = torch.from_numpy(
                    rng.random(units.numel()) < keep_probability)
                kept = units[keep]
                if kept.numel():
                    mask_units = torch.zeros(self._n_units, dtype=torch.bool)
                    mask_units[kept] = True
                    bmask = mask_units.repeat_interleave(ATOM)[: self.size]
                    survivor._durable[bmask] = self._overlay[bmask]
        return survivor

    def corrupt(self, off: int, n: int, rng: Optional[np.random.Generator] = None,
                nbits: int = 8) -> None:
        """Inject an undetected media error: flip bits in the durable image."""
        self._check(off, n)
        rng = rng or np.random.default_rng(0)
        with self._lock:
            for _ in range(nbits):
                pos = off + int(rng.integers(0, n))
                self._durable[pos] ^= 1 << int(rng.integers(0, 8))
            self.stats.media_errors_injected += 1

    # ------------------------------------------------------------------ #
    def dirty_units(self) -> int:
        with self._lock:
            return self._dirty_count

    def _check(self, off: int, n: int) -> None:
        if off < 0 or n < 0 or off + n > self.size:
            raise ValueError(
                f"access [{off}, {off + n}) out of bounds for {self.name} "
                f"(size {self.size})"
            )

    def __repr__(self) -> str:  # pragma: no cover
        return (f"PMEMDevice({self.name}, size={self.size}, mode={self.mode}, "
                f"dirty_units={self.dirty_units()})")


def _as_array(data) -> np.ndarray:
    """Flat uint8 numpy view of a store's source bytes (no copy for
    contiguous buffers)."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    return np.frombuffer(data, dtype=np.uint8)
