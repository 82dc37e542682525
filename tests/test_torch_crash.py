"""Crash consistency of the port's log on the strict PMEM model (core/pmem.py,
core/log.py recovery) against the JAX package on the CPU: the counterparts
of the eight tests of tests/test_crash_consistency.py that
tests/test_torch_log.py does not mirror (it holds
test_forced_records_survive_any_crash,
test_torn_unforced_record_is_dropped_not_surfaced and
test_superline_update_crash_is_atomic).

Power loss may persist any subset of unflushed 8-byte units (torn and
reordered writes) and media errors corrupt persisted bytes.  After every
crash, on both packages:

  C1  recovery succeeds;
  C2  every forced record is recovered intact;
  C3  recovered records are a gap-free LSN prefix extension of the forced
      set;
  C4  no torn or corrupted payload is surfaced;

and where one thread drives the log the two packages recover the same
records from the same crash.  The hypothesis properties draw the same
cases on every run (``derandomize=True``).
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.core as jcore
import repro_torch.core as tcore

from torch_parity import dev_kw, durable, on_both

CAP = 1 << 14


def fresh_log(core):
    dev = core.PMEMDevice(CAP + 4096, mode="strict")
    return dev, core.Log.create(dev, core.LogConfig(capacity=CAP),
                                **dev_kw(core))


def recover(core, dev, seed, keep=0.5):
    survivor = dev.crash(np.random.default_rng(seed), keep_probability=keep)
    return survivor, core.Log.open(survivor, core.LogConfig(capacity=CAP),
                                   **dev_kw(core))


def payload_for(lsn: int) -> bytes:
    rng = np.random.default_rng(lsn)
    return rng.integers(0, 256, size=8 + (lsn * 13) % 200,
                        dtype=np.uint8).tobytes()


def check_invariants(relog, written, forced_upto, cleaned=frozenset()):
    got = {lsn: bytes(p) for lsn, p in relog.iter_records()}      # C4
    expect_certain = {l for l in written if l <= forced_upto
                      and l not in cleaned}
    assert expect_certain <= set(got), \
        f"forced records lost: {sorted(expect_certain - set(got))}"   # C2
    live = sorted(set(got) | {l for l in cleaned if l in written
                              and l <= max(got, default=0)})
    if live:
        assert live == list(range(live[0], live[-1] + 1)), \
            f"hole in committed prefix: {live}"                        # C3
    for lsn, data in got.items():
        assert data == written[lsn], f"record {lsn} corrupted"         # C4
    return got


def never_forced(core):
    dev, log = fresh_log(core)
    written = {}
    for _ in range(10):
        rid, _ = log.reserve(32)
        log.copy(rid, b"u" * 32)
        log.complete(rid)
        written[rid] = b"u" * 32
    # never forced: everything may vanish, but what remains is a prefix
    return [check_invariants(recover(core, dev, seed)[1], written, 0)
            for seed in range(5)]


def test_crash_before_any_force_recovers_empty_or_prefix():
    """test_crash_consistency.py::test_crash_before_any_force_recovers_empty_or_prefix"""
    got, want = on_both(never_forced)
    assert got == want


def scan_media_error(core):
    dev, log = fresh_log(core)
    for i in range(1, 6):
        log.append(payload_for(i))
    rec = log._recs[3]
    dev.corrupt(rec.off + 24, rec.size, np.random.default_rng(7))
    relog = core.Log.open(dev, core.LogConfig(capacity=CAP), **dev_kw(core))
    return {lsn: bytes(p) for lsn, p in relog.iter_records()}, durable(dev)


def test_media_error_detected_on_scan():
    """test_crash_consistency.py::test_media_error_detected_on_scan"""
    got, want = on_both(scan_media_error)
    assert got == want
    # the scan stops at the first integrity failure: 1, 2 survive
    assert got[0] == {1: payload_for(1), 2: payload_for(2)}


def read_media_error(core):
    dev, log = fresh_log(core)
    for i in range(1, 4):
        log.append(payload_for(i))
    relog = core.Log.open(dev, core.LogConfig(capacity=CAP), **dev_kw(core))
    rec = relog._recs[2]
    dev.corrupt(rec.off + 24, rec.size, np.random.default_rng(3))
    seen = []
    with pytest.raises(core.CorruptLogError):
        for lsn, _ in relog.iter_records():
            seen.append(lsn)
    return seen


def test_media_error_after_recovery_raises_on_read():
    """test_crash_consistency.py::test_media_error_after_recovery_raises_on_read"""
    got, want = on_both(read_media_error)
    # the iterator validates before it yields: nothing comes out
    assert got == want == []


@pytest.mark.parametrize("keep,seed", [(1.0, 0), (0.0, 0)]
                         + [(0.5, s) for s in range(6)])
def test_reserve_only_record_recovers_identically(keep, seed):
    """test_crash_consistency.py::test_reserve_only_record_recovers_identically

    One case a (keep, seed) pair of the reference's persistence matrix."""
    def scenario(core):
        dev, log = fresh_log(core)
        written = {}
        for i in range(1, 4):
            data = payload_for(i)
            log.append(data)
            written[i] = data
        log.reserve(64)                      # lsn 4: reserved, never completed
        _, relog = recover(core, dev, seed, keep=keep)
        got = {lsn: bytes(p) for lsn, p in relog.iter_records()}
        return got, relog._next_lsn, written
    got, want = on_both(scenario)
    assert got == want
    recs, next_lsn, written = got
    assert recs == written and next_lsn == 4   # truncated at the hole


def stale_bytes(core):
    dev, log = fresh_log(core)
    for i in range(1, 6):
        log.append(payload_for(i))
    log.cleanupAll()                         # ring bytes stay; head -> lsn 6
    log.reserve(32)                          # lsn 6 over old record 1's image
    _, relog = recover(core, dev, 0, keep=1.0)
    return dict(relog.iter_records()), relog._next_lsn


def test_stale_ring_bytes_not_resurrected_under_reservation():
    """test_crash_consistency.py::test_stale_ring_bytes_not_resurrected_under_reservation"""
    got, want = on_both(stale_bytes)
    assert got == want == ({}, 6)


def live_iter(core):
    dev, log = fresh_log(core)
    for i in range(1, 4):
        log.append(payload_for(i))
    log.reserve(48)                          # in flight, header unwritten
    return {lsn: bytes(p) for lsn, p in log.iter_records()}


def test_live_iter_skips_reserved_uncompleted_record():
    """test_crash_consistency.py::test_live_iter_skips_reserved_uncompleted_record"""
    got, want = on_both(live_iter)
    assert got == want
    assert set(got) == {1, 2, 3}


# --------------------------------------------------------------------- #
# properties
# --------------------------------------------------------------------- #
def pipelined_crash(core, n_ops, crash_seed, keep, depth, freq):
    """A crash at any pipeline stage (rounds issued but not retired,
    retired, never issued) recovers a gapless prefix holding every retired
    record intact.  Which rounds have retired at the crash follows the
    lanes' timing, so each package is held to the invariants."""
    rs = core.build_replica_set(mode="local+remote", capacity=CAP,
                                n_backups=1, write_quorum=2,
                                device_mode="strict", pipeline_depth=depth,
                                **dev_kw(core))
    log = rs.log
    pol = core.FreqPolicy(freq, wait=False)  # non-blocking: pipeline fills
    written = {}
    try:
        for i in range(1, n_ops + 1):
            data = payload_for(i)
            rid, _ = log.reserve(len(data))
            log.copy(rid, data)
            log.complete(rid)
            written[rid] = data
            pol.on_complete(log, rid)
        forced_upto = log.durable_lsn        # sampled mid-pipeline
        _, relog = recover(core, rs.primary_dev, crash_seed, keep=keep)
        got = check_invariants(relog, written, forced_upto)
        return len(got) >= forced_upto
    finally:
        rs.group.drain(timeout=10.0, surface_errors=False)
        rs.shutdown()


@settings(max_examples=25, deadline=None, derandomize=True)
@given(
    n_ops=st.integers(min_value=1, max_value=24),
    crash_seed=st.integers(min_value=0, max_value=2**31),
    keep=st.floats(min_value=0.0, max_value=1.0),
    depth=st.sampled_from([2, 3, 4]),
    freq=st.sampled_from([2, 4]),
)
def test_property_pipelined_crash_gapless_prefix(n_ops, crash_seed, keep,
                                                 depth, freq):
    """test_crash_consistency.py::test_property_pipelined_crash_gapless_prefix"""
    assert on_both(pipelined_crash, n_ops, crash_seed, keep, depth,
                   freq) == (True, True)


OPS = ["append_sync", "append_freq", "write_noforce", "cleanup_head"]


def random_workload(core, ops, crash_seed, keep):
    dev, log = fresh_log(core)
    written, cleaned = {}, set()
    forced_upto = 0
    live_ids = []
    for kind, size in ops:
        if kind == "cleanup_head":
            if live_ids:
                rid = live_ids.pop(0)
                log.cleanup(rid)
                cleaned.add(rid)
            continue
        data = payload_for(len(written) + size)
        try:
            rid, _ = log.reserve(len(data))
        except core.LogError:
            break                      # log full: stop the workload
        log.copy(rid, data)
        log.complete(rid)
        written[rid] = data
        live_ids.append(rid)
        if kind == "append_sync":
            log.force(rid, freq=1)
            forced_upto = max(forced_upto, rid)
        elif kind == "append_freq":
            log.force(rid, freq=4)
            forced_upto = max(forced_upto, log.durable_lsn)
    survivor, relog = recover(core, dev, crash_seed, keep=keep)
    return check_invariants(relog, written, forced_upto, cleaned), \
        durable(survivor)


OPS_STRATEGY = st.lists(
    st.tuples(st.sampled_from(OPS), st.integers(min_value=8, max_value=400)),
    min_size=1, max_size=40)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(ops=OPS_STRATEGY,
       crash_seed=st.integers(min_value=0, max_value=2**31),
       keep=st.floats(min_value=0.0, max_value=1.0))
def test_property_random_workload_crash(ops, crash_seed, keep):
    """test_crash_consistency.py::test_property_random_workload_crash

    One thread drives the log: the survivor's image and the recovered
    records equal the JAX package's."""
    got, want = on_both(random_workload, ops, crash_seed, keep)
    assert got == want


@pytest.mark.parametrize("seed", range(16))
def test_random_workload_crash_seeded(seed):
    """test_crash_consistency.py::test_property_random_workload_crash, at
    16 fixed seeds of numpy's generator (longer workloads that fill the
    ring)."""
    rng = np.random.default_rng(seed)
    ops = [(OPS[int(rng.integers(4))], int(rng.integers(8, 401)))
           for _ in range(int(rng.integers(20, 80)))]
    keep = float(rng.random())
    got, want = on_both(random_workload, ops, int(rng.integers(2**31)), keep)
    assert got == want
