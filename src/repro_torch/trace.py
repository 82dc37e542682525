"""Spans at the port's layer boundaries, for ``torch.profiler``.

``span(name)`` is a context that opens a profiler range named
``repro_torch.<name>`` while a profiler runs, and a shared do-nothing
context otherwise.  The gate is one attribute read:
``torch.autograd.profiler._is_profiler_enabled``, a module global that a
running profiler sets, so it reads true on every thread (the autograd
engine's, a checkpoint's save workers).  The spans exist exactly when
someone profiles; nothing here takes a timestamp or writes a file, and
the ranges land in the profiler's own session, on its clock, beside the
device activity they launch.

A range is an operator-level record (``RecordScope.FUNCTION``, the
profiler's ``cpu_op`` kind), not a user annotation: the profiler mirrors
user annotations onto the device's timeline, where a reader that takes
every device-side event for work would count them as busy time.  As an
operator record a span is the parent of the operators called inside it
(``FunctionEvent.cpu_parent``), and a kernel launched straight from it
(a ctypes launch) is linked to it.

Names follow the modules: ``trainer.*``, ``step.*``, ``optim.*``,
``model.*``, ``log.*``, ``ckpt.*``, ``serve.*``.
"""

from __future__ import annotations

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

PREFIX = "repro_torch."


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def span(name: str):
    """A profiler range ``repro_torch.<name>`` while a profiler runs,
    else the shared do-nothing context."""
    if _profiler._is_profiler_enabled:
        return _RecordFunctionFast(PREFIX + name)
    return _NULL
