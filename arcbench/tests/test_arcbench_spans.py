"""The program spans' reader (``harness/spans.py``) on synthetic traces:
a device mirror of a span is no operation, a CUDA runtime call or a
profiler event on the host is no range, the window, union and gaps are
``trace.read``'s, device time goes to the launching span (a backward
operation through ``sequence_nr``), and an idle gap takes the innermost
span's name."""

import random

import pytest
from torch.autograd import DeviceType

from arcbench.harness import spans, trace

from .common import ROOT  # noqa: F401  (puts src/ on the path)

MS = 1_000_000


class Ev:
    """The part of a raw profiler event that the readers call (as the
    profiler on the card gives it: no ``activity_type``)."""

    def __init__(self, name, start, end, kind="cpu_op", tid=1, corr=0,
                 linked=0, seq=-1, fwd_tid=0):
        self._n, self._s, self._d = name, start, end - start
        self._kind, self._tid, self._corr = kind, tid, corr
        self._linked, self._seq, self._fwd = linked, seq, fwd_tid

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return DeviceType.CUDA if self._kind in (
            "kernel", "gpu_user_annotation") else DeviceType.CPU

    def start_thread_id(self):
        return self._tid

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def sequence_nr(self):
        return self._seq

    def fwd_thread_id(self):
        return self._fwd


class Prof:
    def __init__(self, events):
        self.profiler = self
        self.kineto_results = self
        self._events = events

    def events(self):
        return self._events


def kernel(name, start, end, linked):
    return Ev(name, start * MS, end * MS, kind="kernel", linked=linked)


def host(name, start, end, **kw):
    kind = "user_annotation" if name.startswith("arcbench.") else "cpu_op"
    return Ev(name, start * MS, end * MS, kind=kind, **kw)


def step_trace():
    """One traced step: the window, the harness's step span, the
    program's forward (a norm and an SSD mixer) and backward (on the
    autograd thread 2), the optimizer; a gap at 30-40 ms in the norm."""
    return [
        host("arcbench.window", 0, 100),
        host("arcbench.step", 0, 100),
        host("repro_torch.step.forward", 1, 50),
        host("repro_torch.model.norm", 2, 41),
        host("aten::mul", 3, 4, corr=11, seq=7),
        host("aten::add", 39, 40, corr=12, seq=8),
        host("repro_torch.model.mixer.ssm", 42, 49, corr=13),
        host("repro_torch.step.backward", 50, 80),
        host("autograd::engine::evaluate_function: MulBackward0", 55, 70,
             tid=2, seq=7, fwd_tid=1),
        host("MulBackward0", 56, 69, tid=2, corr=21, seq=7, fwd_tid=1),
        host("autograd::engine::evaluate_function: AccumulateGrad", 71, 72,
             tid=2, fwd_tid=0),
        host("aten::copy_", 71, 72, tid=2, corr=22),
        host("repro_torch.optim.apply_updates", 80, 99),
        host("aten::_foreach_add", 81, 82, corr=31),
        kernel("elementwise_mul", 5, 30, 11),
        kernel("elementwise_add", 40, 42, 12),
        kernel("ssd_chunk_scan_kernel", 43, 50, 13),
        kernel("elementwise_mul_bwd", 57, 70, 21),
        kernel("copy_kernel", 72, 75, 22),
        kernel("adam_kernel", 82, 98, 31),
    ]


def mirrored():
    """The same trace with the device-side mirrors a user annotation of
    the program would add (covering its launches)."""
    return step_trace() + [
        Ev("repro_torch.step.forward", 5 * MS, 50 * MS,
           kind="gpu_user_annotation"),
        Ev("repro_torch.optim.apply_updates", 82 * MS, 98 * MS,
           kind="gpu_user_annotation")]


def runtime(name, start, end, tid=1, corr=0, linked=0):
    """A host event that is no operator and no annotation: a CUDA runtime
    or driver call, or the profiler's own work."""
    return Ev(name, start * MS, end * MS, kind="cuda_runtime", tid=tid,
              corr=corr, linked=linked)


def host_noise():
    """The host events a CUDA trace adds beside the operators: a launch
    call inside each launching operator, with correlation ids of the
    runtime's own count (they meet the operators'), a driver launch, a
    copy and a synchronise, the profiler's buffer request and lazy
    loading inside a launch, and full command buffers that carry the ids
    of the norm's launching operators: one on the autograd thread at the
    norm's launch, one in the backward on the main thread."""
    return [
        runtime("cudaLaunchKernel", 3, 4, corr=12, linked=11),
        runtime("Activity Buffer Request", 3, 4),
        runtime("Command Buffer Full", 3, 4, tid=2, corr=11),
        runtime("Command Buffer Full", 60, 61, corr=12),
        runtime("cudaLaunchKernel", 39, 40, corr=13, linked=12),
        runtime("cuLaunchKernel", 42, 43, corr=11, linked=13),
        runtime("Lazy Function Loading", 42, 43),
        runtime("cudaLaunchKernel", 56, 57, tid=2, corr=22, linked=21),
        runtime("cudaMemcpyAsync", 71, 72, tid=2, corr=21, linked=22),
        runtime("cudaLaunchKernel", 81, 82, corr=14, linked=31),
        runtime("cudaStreamSynchronize", 98, 99, corr=31),
    ]


def test_runtime_calls_and_profiler_events_leave_the_owners():
    """Runtime calls whose correlation ids meet the operators', and the
    profiler's own events inside a launch, leave every owner and gap
    name as they are."""
    plain = spans.read(Prof(step_trace()))
    assert spans.read(Prof(step_trace() + host_noise())) == plain


def random_trace(seed, window):
    """Kernels that overlap, abut and leave gaps, some crossing the
    window's edges, each launched by an operator under a harness span."""
    rng = random.Random(seed)
    events, t = [], 0
    if window:
        events.append(host("arcbench.window", 5, 300))
    for i in range(60):
        t += rng.choice([0, 1, 4, 8, 12])
        d = rng.randint(1, 9)
        c = 100 + i
        events.append(host("arcbench.step" if i % 3 else "arcbench.data",
                           t, t + d))
        events.append(host("aten::mul", t, t + 1, corr=c))
        events.append(kernel(f"k{i % 4}", t + rng.randint(0, 3),
                             t + d + rng.randint(0, 3), c))
    return events


@pytest.mark.parametrize("window", [True, False])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_window_union_and_gaps_are_trace_reads(seed, window):
    """``spans.timeline`` repeats ``trace.read``'s window, union and gaps:
    on the same trace they give the same window, busy time and gaps."""
    events = random_trace(seed, window)
    zero = {f: 0 for f in trace.FAMILIES}
    parent = trace.read(trace.Try(0, 1, prof=Prof(events), before=zero,
                                  after=zero, closed=True))
    dev, host_ranges, _ = spans._raw(Prof(events))
    w0, w1, inside, gaps = spans.timeline(dev, host_ranges)
    assert len(gaps) > 10
    assert (w1 - w0) / 1e9 == parent.window_s
    assert (w1 - w0 - sum(b - a for a, b, _ in gaps)) / 1e9 == \
        parent.busy_s
    assert sorted(((b - a) / 1e9 for a, b, _ in gaps), reverse=True)[:10] \
        == [s for _, s in parent.idle_gaps]
    # each gap is kept with the operation that ends it
    for a, b, i in gaps:
        assert i is None and b == w1 or inside[i][0] == b


def test_mirrors_are_no_operations_and_the_readings_stay_the_parents():
    """Owners are read from the operations alone: the same with or
    without device mirrors of spans, and they add up to the operations
    ``trace.read`` counts in the window."""
    plain = spans.read(Prof(step_trace()))
    assert spans.read(Prof(mirrored())) == plain
    zero = {f: 0 for f in trace.FAMILIES}
    parent = trace.read(trace.Try(0, 1, prof=Prof(step_trace()),
                                  before=zero, after=zero, closed=True))
    assert plain.total_s == pytest.approx(
        sum(s for _, s in parent.device_ops))
    # counted as operations, the mirrors would fill the 30-40 ms gap
    mirrored_parent = trace.read(trace.Try(0, 1, prof=Prof(mirrored()),
                                           before=zero, after=zero,
                                           closed=True))
    assert mirrored_parent.busy_s > parent.busy_s


def test_device_time_goes_to_the_launching_span():
    got = spans.read(Prof(mirrored()), {"ssd_fwd": trace.FAMILIES[
        "ssd_fwd"][0]})
    by = got.device_s_by_span
    # the norm's two launches, and the backward mul on thread 2 through
    # its node's sequence_nr to the norm's mul on thread 1
    assert by["model.norm"] == pytest.approx((25 + 2 + 13) / 1e3)
    assert by["model.mixer.ssm"] == pytest.approx(7 / 1e3)
    assert by["optim.apply_updates"] == pytest.approx(16 / 1e3)
    # AccumulateGrad has no forward operator: step.backward
    assert by["step.backward"] == pytest.approx(3 / 1e3)
    assert set(by) == {"model.norm", "model.mixer.ssm",
                       "optim.apply_updates", "step.backward"}
    assert sum(by.values()) == pytest.approx(got.total_s)
    assert got.total_s == pytest.approx((25 + 2 + 7 + 13 + 3 + 16) / 1e3)
    assert got.family_owners["ssd_fwd"] == {"model.mixer.ssm": 1}


def test_idle_gaps_take_the_innermost_span():
    got = spans.read(Prof(step_trace()))
    # 0-5 and 30-40 ms: the norm open on the launching thread; 50-57 and
    # 70-72: nothing open on the autograd thread, step.backward on the
    # main thread; 75-82: step.backward; 98-100: only the harness's step
    assert got.idle_gaps[0] == ["model.norm", pytest.approx(10 / 1e3)]
    want = {"model.norm": 15, "step.backward": 16, "model.mixer.ssm": 1,
            "step": 2}
    assert got.idle_s_by_span == {k: pytest.approx(v / 1e3)
                                  for k, v in want.items()}


def test_a_save_span_on_another_thread_is_appended():
    events = step_trace() + [
        host("repro_torch.ckpt.encode", 20, 45, tid=3)]
    names = [n for n, _ in spans.read(Prof(events)).idle_gaps]
    assert "model.norm | ckpt.encode" in names
    assert "step.backward" in names


def test_a_program_span_names_a_gap_before_a_harness_span_inside_it():
    events = [
        host("arcbench.window", 0, 20),
        host("repro_torch.trainer.data", 1, 12),
        host("arcbench.data", 2, 11),
        host("aten::copy_", 11, 12, corr=5),
        kernel("copy_kernel", 12, 20, 5),
    ]
    got = spans.read(Prof(events))
    assert got.idle_gaps == [["trainer.data", pytest.approx(12 / 1e3)]]
