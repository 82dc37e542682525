"""The port's pipelined force engine (core/log.py: force, _pipe_issue,
_pipe_await) against the JAX package on the CPU: the counterparts of
tests/test_force_pipeline.py, each naming the JAX test it mirrors.  Its two
cluster scenarios, test_cluster_failover_drains_pipeline_before_fencing
and test_cluster_drain_preserves_deferred_round_errors, are mirrored in
tests/test_torch_health.py::test_cluster_failover_epochs_and_stats_match_jax.

Where the reference keeps a round in flight with a long injected delay,
the port's test holds the backup's lane (``hold_writes``) until the state
it needs has been reached, so the scenario runs the same on every run and
its outcome is compared with the JAX package's.
"""

import threading
import time

import pytest

import repro.core as jcore
import repro_torch.core as tcore

from torch_parity import dev_kw, hold_until_fenced, hold_writes, on_both, \
    wait_until

CAP = 1 << 16


def pipelined(core, depth, n_backups=2, write_quorum=2, **kw):
    return core.build_replica_set(mode="local+remote", capacity=CAP,
                                  n_backups=n_backups,
                                  write_quorum=write_quorum,
                                  pipeline_depth=depth, **kw, **dev_kw(core))


def stream(log, pol, n, size=64):
    for _ in range(n):
        rid, ptr = log.reserve(size)
        ptr[:] = b"x" * size
        log.complete(rid)
        pol.on_complete(log, rid)


def reserve_complete(log, data):
    rid, ptr = log.reserve(len(data))
    ptr[:] = data
    log.complete(rid)
    return rid


def record_counts(core, rs):
    return [len(list(core.Log.open(s.device, core.LogConfig(capacity=CAP),
                                   **dev_kw(core)).iter_records()))
            for s in rs.servers]


# --------------------------------------------------------------------- #
# overlap + in-order retirement
# --------------------------------------------------------------------- #
def overlap(core, depth):
    """12 rounds over a 10 ms wire, priced at the injected delay: the
    modelled time of the measured section, and the most rounds seen in
    flight at once."""
    rs = pipelined(core, depth, cost=core.CostModel().with_wire_rtt(1e7))
    try:
        log = rs.log
        pol = core.FreqPolicy(4, wait=False)
        stream(log, pol, 8)                 # warm the whole path, undelayed
        pol.drain(log)
        for t in rs.transports:
            t.inject(delay_s=0.01)
        v0 = log.durable_vtime
        peak = 0
        for _ in range(12):
            stream(log, pol, 4)
            peak = max(peak, log.stats()["inflight_rounds"])
        modelled = pol.drain(log) - v0
        assert log.durable_lsn == 56
        rs.group.drain(timeout=10.0)
        return modelled, peak, record_counts(core, rs)
    finally:
        rs.shutdown()


def test_pipeline_depth_overlaps_wire_rounds():
    """test_force_pipeline.py::test_pipeline_depth_overlaps_wire_rounds

    The reference times the two depths by the wall clock; here the
    modelled timeline of each (equal to the JAX package's at depth 1, and
    within 0.1% at depth 4, where stragglers' acks land in any order) and
    the rounds seen in flight at once."""
    serial, serial_j = on_both(overlap, 1)
    deep, deep_j = on_both(overlap, 4)
    assert serial == serial_j
    assert deep[1:] == deep_j[1:]
    assert abs(deep[0] - deep_j[0]) <= 1e-3 * deep_j[0]
    assert serial[1] == 1 and deep[1] > 1
    assert deep[0] < serial[0] * 0.7, (deep[0], serial[0])


def gapless_writers(core):
    rs = pipelined(core, 4)
    try:
        log = rs.log
        pol = core.FreqPolicy(2, wait=False)
        errors = []

        def worker():
            try:
                for _ in range(30):
                    rid = reserve_complete(log, b"c" * 16)
                    pol.on_complete(log, rid)
                    d = log.durable_lsn
                    c = log.completed_lsn      # read after d: c >= c@d
                    assert d <= c, f"watermark {d} ahead of complete {c}"
            except Exception as e:             # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=worker) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        pol.drain(log)
        assert not errors, errors
        rs.group.drain(timeout=10.0)
        return (log.durable_lsn, log.stats()["inflight_rounds"],
                record_counts(core, rs))
    finally:
        rs.shutdown()


def test_concurrent_writers_gapless_watermark():
    """test_force_pipeline.py::test_concurrent_writers_gapless_watermark"""
    got, want = on_both(gapless_writers)
    assert got == want == (120, 0, [120, 120])


def wait_false(core):
    rs = pipelined(core, 4, n_backups=1, write_quorum=2)
    try:
        log = rs.log
        log.append(b"w")
        log.drain(timeout=10.0)
        returned = []
        hold_writes(rs.transports[0], lambda: bool(returned),
                    what="the non-blocking force's return")
        rid = reserve_complete(log, b"q" * 8)
        log.force(rid, wait=False)          # must return with the round held
        returned.append(log.durable_lsn)
        log.drain(timeout=10.0)
        rs.group.drain(timeout=10.0)
        return rid, returned[0], log.durable_lsn
    finally:
        rs.shutdown()


def test_wait_false_returns_before_quorum():
    """test_force_pipeline.py::test_wait_false_returns_before_quorum

    The backup's lane holds the round until the force has returned, so a
    force that waited for the quorum would time out the hold."""
    got, want = on_both(wait_false)
    assert got == want == (2, 1, 2)


# --------------------------------------------------------------------- #
# failure paths
# --------------------------------------------------------------------- #
def flush_dies(core):
    dev = core.PMEMDevice(core.device_size(CAP))
    log = core.Log.create(dev, core.LogConfig(capacity=CAP), **dev_kw(core))
    rid = reserve_complete(log, b"a" * 8)
    orig = dev.persist
    dev.persist = lambda off, n: (_ for _ in ()).throw(
        RuntimeError("flush died"))
    with pytest.raises(RuntimeError):
        log.force(rid)
    dev.persist = orig
    out = [log.stats()["inflight_rounds"], log._force_busy]
    out += [log.force(rid), log.durable_lsn]   # no deferred re-raise, no wedge
    return out


def test_force_exception_resets_pipeline_and_unblocks_later_forces():
    """test_force_pipeline.py::test_force_exception_resets_pipeline_and_unblocks_later_forces"""
    got, want = on_both(flush_dies)
    assert got == want == [0, False, 1, 1]


def incomplete_timeout(core):
    dev = core.PMEMDevice(core.device_size(CAP))
    log = core.Log.create(dev, core.LogConfig(capacity=CAP), **dev_kw(core))
    rid, ptr = log.reserve(8)
    with pytest.raises(core.LogError, match="complete_upto"):
        log.force(rid, timeout=0.05)       # never completed: times out
    ptr[:] = b"b" * 8
    log.complete(rid)
    return log.force(rid), stats_of(dev)


def stats_of(dev):
    return dict(dev.stats.__dict__)


def test_force_timeout_on_incomplete_record_does_not_wedge():
    """test_force_pipeline.py::test_force_timeout_on_incomplete_record_does_not_wedge"""
    got, want = on_both(incomplete_timeout)
    assert got == want
    assert got[0] == 1


def stuck_round(core):
    rs = pipelined(core, 2, n_backups=1, write_quorum=2)
    try:
        log = rs.log
        log.append(b"w")
        timed_out = []
        hold_writes(rs.transports[0], lambda: bool(timed_out),
                    what="the force's timeout")
        rid = reserve_complete(log, b"s" * 8)
        with pytest.raises(core.LogError, match="to retire") as ei:
            log.force(rid, timeout=0.05)    # round still on the wire
        timed_out.append(ei.value)
        rid2 = reserve_complete(log, b"t" * 8)
        # once the wire settles, the pipeline keeps retiring in order
        out = [log.force(rid2, timeout=10.0)]
        log.drain(timeout=10.0)
        rs.group.drain(timeout=10.0)
        return out + [log.durable_lsn, log.depth_trajectory]
    finally:
        rs.shutdown()


def test_force_timeout_on_stuck_round_does_not_wedge_later_forces():
    """test_force_pipeline.py::test_force_timeout_on_stuck_round_does_not_wedge_later_forces"""
    got, want = on_both(stuck_round)
    assert got == want == [3, 3, [(0, 2)]]


def covered_waiters(core):
    rs = pipelined(core, 2, n_backups=2, write_quorum=3)
    try:
        log = rs.log
        log.append(b"w")
        hold_until_fenced(rs.transports[0])  # node1's wire holds both rounds
        results = []

        def forcer(rid):
            try:
                log.force(rid, timeout=10.0)
                results.append(None)
            except Exception as e:
                results.append(e)

        threads = []
        for i in range(2):
            rid = reserve_complete(log, bytes([i]) * 8)
            th = threading.Thread(target=forcer, args=(rid,))
            th.start()
            threads.append(th)
            wait_until(lambda: log.stats()["issue_lsn"] >= rid,
                       f"round {rid}'s issue")
        rs.servers[0].fence("node0")         # node1 now rejects the writes
        for th in threads:
            th.join(timeout=30.0)
        assert not any(th.is_alive() for th in threads)
        rs.group.drain(timeout=10.0, surface_errors=False)
        return ([type(r).__name__ for r in results],
                log.stats()["inflight_rounds"], log.durable_lsn)
    finally:
        rs.shutdown()


def test_pipelined_quorum_error_propagates_to_all_covered_waiters():
    """test_force_pipeline.py::test_pipelined_quorum_error_propagates_to_all_covered_waiters"""
    got, want = on_both(covered_waiters)
    assert got == want == (["QuorumError", "QuorumError"], 0, 1)


def deferred_on_drain(core):
    rs = pipelined(core, 2, n_backups=2, write_quorum=3)
    try:
        log = rs.log
        log.append(b"w")
        rs.fail_backup("node1")              # W=3 now unreachable
        rid = reserve_complete(log, b"z" * 8)
        log.force(rid, wait=False)
        with pytest.raises(core.QuorumError):
            log.drain(timeout=10.0)
        return log.stats()["inflight_rounds"], log.durable_lsn
    finally:
        rs.shutdown()


def test_wait_false_round_failure_surfaces_on_drain():
    """test_force_pipeline.py::test_wait_false_round_failure_surfaces_on_drain"""
    got, want = on_both(deferred_on_drain)
    assert got == want == (0, 1)


def pipelined_window(core):
    rs = pipelined(core, 4, n_backups=1, write_quorum=2)
    try:
        log = rs.log
        log.cfg.max_threads = 1              # single writer: T = 1
        rs.transports[0].inject(delay_s=0.05)  # keep rounds in flight
        pol = core.FreqPolicy(4, wait=False)
        bound = pol.vulnerability_bound(log)
        worst = 0
        for _ in range(32):
            rid = reserve_complete(log, b"v" * 8)
            pol.on_complete(log, rid)
            worst = max(worst, log.vulnerability_window())
        pol.drain(log)
        rs.group.drain(timeout=10.0)
        assert worst <= bound, f"window {worst} exceeds pipelined bound"
        assert worst > 4, "pipeline never extended the window (test inert)"
        return bound, log.durable_lsn
    finally:
        rs.shutdown()


def test_wait_false_window_stays_within_pipelined_bound():
    """test_force_pipeline.py::test_wait_false_window_stays_within_pipelined_bound

    The worst window seen follows the wire's timing; each package is held
    to the bound and the bound is compared."""
    got, want = on_both(pipelined_window)
    assert got == want == (4 * 1 * (4 + 1), 32)


def durable_fast_path(core):
    rs = pipelined(core, 1, n_backups=1, write_quorum=2)
    try:
        log = rs.log
        log.append(b"a")                     # lsn 1 durable
        answered = []
        hold_writes(rs.transports[0], lambda: bool(answered),
                    what="the durable-LSN force's answer")
        rid2 = reserve_complete(log, b"b" * 8)
        log.force(rid2, wait=False)          # round 2 held on the wire
        rid3 = reserve_complete(log, b"c" * 8)
        blocker = threading.Thread(target=log.force, args=(rid3,),
                                   kwargs=dict(timeout=30.0))
        blocker.start()                      # waits for a depth-1 slot
        wait_until(lambda: log._issue_lock.locked(),
                   "the slot-waiting leader's issue lock")
        asker = threading.Thread(target=lambda: answered.append(log.force(1)))
        asker.start()
        # the hold releases only once force(1) has answered: if it queued
        # behind the issue lock the two would wait on each other
        asker.join(timeout=10.0)
        ok = not asker.is_alive()
        answered.append(-1)                  # release the lane either way
        asker.join(timeout=10.0)
        blocker.join(timeout=30.0)
        assert ok, "durable-LSN force queued behind the issue lock"
        assert not blocker.is_alive()
        log.drain(timeout=10.0)
        rs.group.drain(timeout=10.0)
        return answered[0], log.durable_lsn
    finally:
        rs.shutdown()


def test_force_on_durable_lsn_does_not_block_behind_issue_lock():
    """test_force_pipeline.py::test_force_on_durable_lsn_does_not_block_behind_issue_lock"""
    got, want = on_both(durable_fast_path)
    assert got == want == (1, 3)


# --------------------------------------------------------------------- #
# deferred-error backlog coalescing
# --------------------------------------------------------------------- #
def error_storm(core):
    rs = pipelined(core, 4, n_backups=2, write_quorum=3)
    try:
        log = rs.log
        log.append(b"w")                     # lsn 1 durable
        rs.fail_backup("node1")              # W=3 unreachable from now on
        for _ in range(3):                   # three sequential failed rounds
            rid = reserve_complete(log, b"z" * 8)
            log.force(rid, wait=False)
            wait_until(lambda: log.stats()["inflight_rounds"] == 0,
                       "the failed round's settle")
        backlog = log.stats()["deferred_errors"]
        with pytest.raises(core.QuorumError) as ei:
            log.drain(timeout=10.0)
        out = [backlog, len(ei.value.pipe_backlog),
               log.stats()["deferred_errors"]]
        log.drain(timeout=10.0)              # second drain MUST be clean
        return out + [log.durable_lsn]
    finally:
        rs.shutdown()


def test_deferred_error_storm_coalesces_into_one_drain():
    """test_force_pipeline.py::test_deferred_error_storm_coalesces_into_one_drain"""
    got, want = on_both(error_storm)
    assert got == want
    backlog, riding, left, durable = got
    assert backlog >= 2, "storm never accumulated a backlog (test inert)"
    assert riding == backlog - 1 and left == 0 and durable == 1


# --------------------------------------------------------------------- #
# tightened vulnerability bound: per-round-span accounting
# --------------------------------------------------------------------- #
def span_bound(core):
    rs = pipelined(core, 1, n_backups=1, write_quorum=2)
    try:
        log = rs.log
        log.cfg.max_threads = 1              # T = 1
        pol_w = core.FreqPolicy(4, wait=True)
        out = [pol_w.vulnerability_bound(log),
               pol_w.effective_vulnerability_bound(log)]
        pol = core.FreqPolicy(4, wait=False)
        out += [pol.vulnerability_bound(log),
                pol.effective_vulnerability_bound(log), log.inflight_span()]
        # park one small round in flight until the bound has been read
        read = []
        hold_writes(rs.transports[0], lambda: bool(read),
                    what="the live-span reading")
        rid = reserve_complete(log, b"s" * 8)
        log.force(rid, wait=False)
        read += [log.inflight_span(), pol.effective_vulnerability_bound(log),
                 pol.vulnerability_bound(log)]
        log.drain(timeout=10.0)
        out += read + [pol.effective_vulnerability_bound(log)]
        rs.group.drain(timeout=10.0)
        return out
    finally:
        rs.shutdown()


def test_effective_bound_per_round_span_accounting_at_depth1():
    """test_force_pipeline.py::test_effective_bound_per_round_span_accounting_at_depth1"""
    got, want = on_both(span_bound)
    assert got == want
    # wait=True: F×T both; wait=False: static 2·F·T, effective F·T idle,
    # F·T + the live span with one round parked, back to F·T drained
    assert got == [4, 4, 8, 4, 0, 1, 5, 8, 4]
