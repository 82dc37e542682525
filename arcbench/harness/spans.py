"""The program's own spans in a traced try: device time and idle gaps put
down to the port's layers.

The port opens profiler ranges named ``repro_torch.<module>.<part>``
(``repro_torch/trace.py``) while a profiler runs, as operator records on
the thread that runs the code: the trainer's fetch and sync, the step's
forward, backward and hash, the optimizer, the model's embedding, casts,
norms, mixers, MLPs, head and loss, the log's force, the checkpoint's
snapshot, encode, puts and manifest, the server's prefill, decode and
syncs.  An operator record has no mirror on the device's timeline (a
user annotation, as the harness's spans are, has one), so ``trace.read``
reads the same numbers from a trace with or without them.  This module
reads them from a finished profile beside the harness's own
``arcbench.*`` spans; a device-side event named by either kind of span
is no operation and is left out.

- ``device_s_by_span`` puts each device operation's time down to the
  innermost program span open around the operator that launched it
  (the profiler links an operation to that operator by correlation id).
  An operation launched from the backward pass (under an autograd node's
  ``evaluate_function``) goes to the span that enclosed the node's forward
  operator, matched by (thread, ``sequence_nr``); with none it goes to
  ``step.backward``.  A remat recompute inside the backward runs the
  model's code again, so its own spans own what it launches.
- ``idle_gaps`` names each gap of the device by the innermost program
  span open at the gap's middle on the thread that launched the operation
  ending the gap, or the innermost harness span where no program span is
  (where neither is open there, as on the autograd thread between
  recomputes, the innermost open on any thread but a save's), with
  `` | ckpt.*`` appended where a checkpoint span is open on another thread
  then.

Nothing here changes a reading of ``trace.read``; it only adds owners.
The device seconds it puts down are ``trace.read``'s operations in the
window, each counted whole (their sum is not the union ``busy_s``).
``timeline`` repeats ``trace.read``'s window, union and gaps, since that
file keeps them inside ``read``; ``test_arcbench_spans`` holds the two
equal on the same trace.

A host range is any host event but a CUDA runtime or driver call, told by
its name (``cuda*``, ``cu*``): the raw events give no field that marks an
operator on every profiler version (the card's has no ``activity_type``,
and its ``scope()`` reads 0 for runtime calls too).  A runtime call is left
out because its correlation id counts in the runtime's own sequence and
meets the operators' ids, which link the kernels to their launchers; it
serves to tell the launching operator where an id is shared
(``launchers``).  The profiler's and the runtime's other host events
(buffer requests and flushes, a full command buffer) run inside the call
that caused them and are kept as ranges; on the card one to three of a
try's 70,000-350,000 ranges crossed the end of the range around them.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import trace

PROGRAM = "repro_torch."
HARNESS = trace.SPAN_PREFIX
NODE = "autograd::engine::evaluate_function"
BACKWARD = "step.backward"
NO_OP = "(no launching operator)"
OUTSIDE = "(outside the program's spans)"
SAVE = "ckpt."
_RUNTIME = re.compile(r"cu(da)?[A-Z]")


@dataclass
class Op:
    """A host range: an operator, a program span or a harness span."""
    tid: int
    start: int
    end: int
    name: str
    corr: int
    seq: int
    fwd_tid: int
    parent: Optional["Op"] = None


@dataclass
class Owners:
    device_s_by_span: Dict[str, float]
    idle_gaps: List[list]                  # [name, seconds], longest first
    idle_s_by_span: Dict[str, float]       # every gap's seconds by name
    total_s: float                         # device seconds in the window
    by_span_op: Dict[Tuple[str, str], float]   # (owner, operation) seconds
    family_owners: Dict[str, Dict[str, int]] = field(default_factory=dict)


def _raw(prof):
    """(device operations [(start, end, name, linked corr)], host ranges
    [Op], runtime calls [(thread, start, linked corr)]) of a finished
    profile, mirrors of either kind of span left out."""
    from torch.autograd import DeviceType
    dev, host, calls = [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith((PROGRAM, HARNESS)):
                dev.append((start, end, name, e.linked_correlation_id()))
        elif _RUNTIME.match(name):
            calls.append((e.start_thread_id(), start,
                          e.linked_correlation_id()))
        else:
            host.append(Op(e.start_thread_id(), start, end, name,
                           e.correlation_id(), e.sequence_nr(),
                           e.fwd_thread_id()))
    _nest(host)
    return dev, host, calls


def launchers(host: List[Op], calls) -> Dict[int, Op]:
    """The range behind each correlation id a device operation links to.
    The runtime's own host events (a stalled launch's ``Command Buffer
    Full``, a ``Buffer Flush``) carry ids of the runtime's count, which
    meet the operators'; where two ranges carry one id, the one that holds
    a runtime call linked to it (on its thread, in its time) is the
    operator."""
    shared: Dict[int, List[Op]] = {}
    for o in host:
        if o.corr > 0:
            shared.setdefault(o.corr, []).append(o)
    out = {c: os[-1] for c, os in shared.items()}
    for tid, t, c in calls:
        held = [o for o in shared.get(c, ())
                if o.tid == tid and o.start <= t <= o.end]
        if held:
            out[c] = held[-1]
    return out


def _nest(host: List[Op]) -> None:
    """Each range's parent: the innermost range of its thread that holds
    it."""
    host.sort(key=lambda o: (o.tid, o.start, -o.end))
    stack: List[Op] = []
    for o in host:
        while stack and (stack[-1].tid != o.tid or stack[-1].end <= o.start):
            stack.pop()
        o.parent = stack[-1] if stack else None
        stack.append(o)


def _up(o: Optional[Op]):
    while o is not None:
        yield o
        o = o.parent


def _span_of(o: Optional[Op]) -> Optional[str]:
    """The innermost program span holding ``o`` (``o`` itself included)."""
    for a in _up(o):
        if a.name.startswith(PROGRAM):
            return a.name[len(PROGRAM):]
    return None


def owner_map(host: List[Op]):
    """A function from a launching operator to its owner's name."""
    forward: Dict[Tuple[int, int], Op] = {}
    for o in host:
        if o.seq >= 0 and not any(a.name.startswith(NODE) for a in _up(o)):
            forward.setdefault((o.tid, o.seq), o)

    def owner(o: Optional[Op]) -> str:
        if o is None:
            return NO_OP
        for a in _up(o):
            if a.name.startswith(PROGRAM):
                return a.name[len(PROGRAM):]
            if a.name.startswith(NODE):
                return _span_of(forward.get((a.fwd_tid, a.seq))) or BACKWARD
        harness = next((a.name for a in _up(o)
                        if a.name.startswith(HARNESS)), None)
        return harness or OUTSIDE
    return owner


def timeline(dev, host):
    """(window start, window end, the device operations inside the window
    clipped to it and in order, the gaps): ``trace.read``'s window (the
    harness's window span, else the operations' extent) and the stretches
    of it in which no device operation runs, each gap kept with the index
    of the operation that ends it (None for the window's end)."""
    win = [o for o in host if o.name == trace.WINDOW_SPAN]
    if win:
        w0, w1 = win[0].start, win[0].end
    else:
        w0 = min((d[0] for d in dev), default=0)
        w1 = max((d[1] for d in dev), default=0)
    inside = sorted((max(s, w0), min(e, w1), n, c) for s, e, n, c in dev
                    if e > w0 and s < w1)
    gaps, cur_e = [], None
    for i, (s, e, _, _) in enumerate(inside):
        if cur_e is None:
            if s > w0:
                gaps.append((w0, s, i))
            cur_e = e
        elif s > cur_e:
            gaps.append((cur_e, s, i))
            cur_e = e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None and cur_e < w1:
        gaps.append((cur_e, w1, None))
    return w0, w1, inside, gaps


def read(prof, families: Optional[Dict[str, str]] = None) -> Owners:
    """The owners of the try's device time and the names of its idle
    gaps.  ``families`` (name -> pattern, ``trace.FAMILIES``'s) also counts
    each family's operations by owner."""
    dev, host, calls = _raw(prof)
    _, _, inside, gaps = timeline(dev, host)
    by_corr = launchers(host, calls)
    owner = owner_map(host)
    by_span: Dict[str, float] = {}
    by_op: Dict[Tuple[str, str], float] = {}
    fam = {f: re.compile(p) for f, p in (families or {}).items()}
    fam_owners: Dict[str, Dict[str, int]] = {f: {} for f in fam}
    total = 0
    for s, e, n, c in inside:
        who = owner(by_corr.get(c))
        by_span[who] = by_span.get(who, 0.0) + (e - s) / 1e9
        by_op[who, n] = by_op.get((who, n), 0.0) + (e - s) / 1e9
        total += e - s
        for f, rx in fam.items():
            if rx.search(n):
                fam_owners[f][who] = fam_owners[f].get(who, 0) + 1

    def is_span(o: Op) -> bool:
        return o.name.startswith((PROGRAM, HARNESS)) and \
            o.name != trace.WINDOW_SPAN

    spans: Dict[int, List[Op]] = {}
    outer: Dict[int, Optional[Op]] = {}     # id(span) -> enclosing span
    for o in host:
        if is_span(o):
            spans.setdefault(o.tid, []).append(o)
            outer[id(o)] = next((a for a in _up(o.parent) if is_span(a)),
                                None)
    starts = {tid: [o.start for o in ss] for tid, ss in spans.items()}

    def open_at(tid: int, t: int) -> Optional[Op]:
        """The innermost program span of ``tid`` open at ``t``, else the
        innermost harness span (spans nest)."""
        i = bisect.bisect_right(starts.get(tid, []), t) - 1
        o = spans[tid][i] if i >= 0 else None
        while o is not None and o.end <= t:
            o = outer[id(o)]
        first = o
        while o is not None and not o.name.startswith(PROGRAM):
            o = outer[id(o)]
        return o or first

    def name(o: Op) -> str:
        return o.name[len(PROGRAM):] if o.name.startswith(PROGRAM) \
            else o.name[len(HARNESS):]

    idle, idle_by = [], {}
    for a, b, i in gaps:
        mid = (a + b) // 2
        launcher = by_corr.get(inside[i][3]) if i is not None else None
        here = open_at(launcher.tid, mid) if launcher is not None else None
        if here is None:
            # no span open where the next operation came from (the
            # autograd thread between recomputes): the innermost open on
            # a thread that is not the save's
            found = [o for o in (open_at(tid, mid) for tid in spans)
                     if o is not None and
                     not o.name.startswith(PROGRAM + SAVE)]
            here = min(found, key=lambda o: o.end - o.start) \
                if found else None
        label = name(here) if here is not None else OUTSIDE
        others = sorted({name(o) for tid in spans
                         if here is None or tid != here.tid
                         for o in [open_at(tid, mid)]
                         if o is not None and
                         o.name.startswith(PROGRAM + SAVE)})
        if others:
            label += " | " + " | ".join(others)
        idle.append([label, (b - a) / 1e9])
        idle_by[label] = idle_by.get(label, 0.0) + (b - a) / 1e9
    idle.sort(key=lambda x: -x[1])
    return Owners(device_s_by_span=by_span, idle_gaps=idle[:10],
                  idle_s_by_span=idle_by, total_s=total / 1e9,
                  by_span_op=by_op, family_owners=fam_owners)


def top(by: dict, n: int = 10) -> List[list]:
    """The ``n`` largest entries of a dict of seconds, as [key, s]."""
    return sorted(([k, v] for k, v in by.items()), key=lambda x: -x[1])[:n]
