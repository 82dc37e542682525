"""The traced part of a ``--trace 1`` run.

``TraceWindow`` profiles a steady stretch of the measured window with
``torch.profiler`` (host and device activity): ``units`` units (steps or
batches) after the first ``skip``, and, as a second try, the same number
again right after.  Each try records the port's launch counters before
and after.  Once the window has closed, the first try whose trace holds
every kernel the counters say was launched is read; the profiler has
dropped ctypes-launched kernels before, and a partial trace would report
a roofline share of work it did not see, so with no complete try the run
fails.

The harness's own spans (``record_function``, names ``arcbench.*``) wrap
the calls it makes into the program; an idle gap of the device is named
by the innermost such span open on the host at the gap's middle.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

# kernel family -> (name pattern, kernels a counted call launches)
FAMILIES: Dict[str, Tuple[str, int]] = {
    "ssd_fwd": (r"ssd_(chunk_state|state_passing|chunk_scan)_kernel|"
                r"ssd_cc_(chunk_state|state_passing|chunk_scan)", 3),
    "ssd_bwd": (r"bwd_(tc|cc)_(chunk_sums|state_passes|pairs|columns|group|"
                r"finalize|dA_log)", 7),
    "flash_fwd": (r"flash_fwd_(wgmma|kernel)", 1),
    "flash_bwd": (r"flash_bwd_(tc_)?(delta|dkdv|dq)", 3),
    "hash": (r"checksum_(short_)?rows_kernel", 1),
}
WINDOW_SPAN = "arcbench.window"
SPAN_PREFIX = "arcbench."


class TraceIncomplete(RuntimeError):
    pass


def counters() -> Dict[str, int]:
    """The port's launch counters: calls of each kernel family."""
    from repro_torch.kernels.checksum import checksum
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"ssd_fwd": ssd_scan.LAUNCHES,
            "ssd_bwd": ssd_scan.BACKWARD_LAUNCHES,
            "flash_fwd": flash_attention.LAUNCHES,
            "flash_bwd": flash_attention.BACKWARD_LAUNCHES,
            "hash": checksum.LAUNCHES}


def span(name: str, on: bool):
    """A harness span around a call into the program (a no-op context
    when the run is not traced)."""
    if on:
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return _Null()


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@dataclass
class Try:
    first: int
    last: int                       # units [first, last)
    prof: object = None
    rf: object = None
    before: Dict[str, int] = field(default_factory=dict)
    after: Dict[str, int] = field(default_factory=dict)
    closed: bool = False


@dataclass
class TraceSummary:
    first: int
    last: int
    busy_s: float
    window_s: float
    calls: Dict[str, int]            # counted calls of each family
    kernel_ms: Dict[str, float]      # device ms of each family's kernels
    kernel_count: Dict[str, int]
    device_ops: List[list]
    idle_gaps: List[list]


class TraceWindow:
    def __init__(self, enabled: bool, skip: int, units: int):
        self.enabled = enabled
        self.tries = [Try(skip, skip + units),
                      Try(skip + units + 1, skip + 2 * units + 1)] \
            if enabled else []
        self._open: Optional[Try] = None

    def units_needed(self) -> int:
        return self.tries[0].last + 1 if self.tries else 0

    def unit(self, i: int) -> None:
        """Called at the start of unit ``i`` of the window."""
        if not self.enabled:
            return
        if self._open is not None and i == self._open.last:
            self._stop()
        for t in self.tries:
            if i == t.first and not t.closed:
                self._start(t)

    def finish(self) -> None:
        """Called once the window's last unit has ended."""
        if self._open is not None:
            self._stop()

    def _start(self, t: Try) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        t.prof = profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA])
        t.prof.start()
        t.before = counters()
        t.rf = torch.profiler.record_function(WINDOW_SPAN)
        t.rf.__enter__()
        self._open = t

    def _stop(self) -> None:
        t = self._open
        torch.cuda.synchronize()
        t.rf.__exit__(None, None, None)
        t.after = counters()
        t.prof.stop()
        t.closed = True
        self._open = None

    def summary(self, log: Callable[[str], None]) -> TraceSummary:
        """The first complete try, read; raises ``TraceIncomplete`` when
        no try holds every launched kernel."""
        notes = []
        for t in self.tries:
            if not t.closed:
                notes.append(f"units {t.first}-{t.last}: not reached")
                continue
            s = read(t)
            short = {f: (s.kernel_count[f], s.calls[f] * FAMILIES[f][1])
                     for f in FAMILIES
                     if s.kernel_count[f] < s.calls[f] * FAMILIES[f][1]}
            if not short and s.busy_s > 0:
                return s
            notes.append(f"units {t.first}-{t.last}: kernels found/launched "
                         f"{short}, busy {s.busy_s}")
            log(f"trace try incomplete: {notes[-1]}")
        raise TraceIncomplete("no complete trace: " + "; ".join(notes))


def _events(prof):
    """(device intervals [(start_ns, end_ns, name)], host spans of the
    harness [(start_ns, end_ns, name)]) of a finished profile."""
    from torch.autograd import DeviceType
    dev, host = [], []
    kineto = getattr(prof.profiler, "kineto_results", None)
    if kineto is not None and hasattr(kineto, "events"):
        rows = ((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                 e.device_type()) for e in kineto.events())
    else:                       # the parsed events, in microseconds
        rows = ((e.name, int(e.time_range.start * 1e3),
                 int(e.time_range.end * 1e3), e.device_type)
                for e in prof.events())
    for name, start, end, kind in rows:
        if name.startswith(SPAN_PREFIX):
            # a harness span; the profiler mirrors each onto the device's
            # timeline too, where it is no operation
            if kind != DeviceType.CUDA:
                host.append((start, end, name[len(SPAN_PREFIX):]))
        elif kind == DeviceType.CUDA:
            dev.append((start, end, name))
    return dev, host


def read(t: Try) -> TraceSummary:
    dev, host = _events(t.prof)
    win = [h for h in host if h[2] == WINDOW_SPAN[len(SPAN_PREFIX):]]
    if win:
        w0, w1 = win[0][0], win[0][1]
    else:
        w0 = min((d[0] for d in dev), default=0)
        w1 = max((d[1] for d in dev), default=0)
    spans = [h for h in host if h[2] != WINDOW_SPAN[len(SPAN_PREFIX):]]
    inside = sorted((max(s, w0), min(e, w1), n) for s, e, n in dev
                    if e > w0 and s < w1)
    # the union of device activity, and the gaps between its pieces
    busy, gaps, cur_s, cur_e = 0, [], None, None
    for s, e, _ in inside:
        if cur_e is None:
            if s > w0:
                gaps.append((w0, s))
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        if cur_e < w1:
            gaps.append((cur_e, w1))
    by_name: Dict[str, float] = {}
    for s, e, n in inside:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
    device_ops = sorted(([n[:120], v] for n, v in by_name.items()),
                        key=lambda x: -x[1])[:10]

    def who(mid):
        open_ = [(e - s, n) for s, e, n in spans if s <= mid < e]
        return min(open_)[1] if open_ else "outside the harness's spans"

    idle = sorted(([who((a + b) // 2), (b - a) / 1e9] for a, b in gaps),
                  key=lambda x: -x[1])[:10]
    kernel_ms, kernel_count = {}, {}
    for fam, (pat, _) in FAMILIES.items():
        rx = re.compile(pat)
        hits = [(s, e) for s, e, n in inside if rx.search(n)]
        kernel_ms[fam] = sum(e - s for s, e in hits) / 1e6
        kernel_count[fam] = len(hits)
    calls = {f: t.after[f] - t.before[f] for f in FAMILIES}
    return TraceSummary(first=t.first, last=t.last, busy_s=busy / 1e9,
                        window_s=(w1 - w0) / 1e9, calls=calls,
                        kernel_ms=kernel_ms, kernel_count=kernel_count,
                        device_ops=device_ops, idle_gaps=idle)
