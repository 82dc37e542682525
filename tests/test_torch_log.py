"""The port's log against the JAX package's log, on the CPU.

The same append sequences (scalar and batched, across ring wraps, with
and without the lane-polynomial hash) go through both packages; ring
images, record maps, DeviceStats and force vns must be identical.  Logs
written by one package open in the other, corruption truncates at the
same LSN, the port's vectorized recovery plan equals its sequential
walk (and the JAX package's plan), and seeded strict crash schedules
recover the same LSN chain in both.
"""

import struct
import zlib

import numpy as np
import pytest
import torch

from repro.core.log import Log as JaxLog, LogConfig as JaxConfig
from repro.core.pmem import PMEMDevice as JaxPMEM
from repro_torch.core import log as tlog
from repro_torch.core.log import (FLAG_PHASH, REC_HDR_SIZE, _REC_HDR,
                                  CorruptLogError, Log, LogConfig,
                                  _LSN_VEC_MIN)
from repro_torch.core.pmem import PMEMDevice
from repro_torch.core.replication import device_size

from torch_parity import (durable, payload_for, rec_shape, stats, to_jax,
                          to_port)

CAP = 4096


def pair(mode="strict", cap=CAP, **cfg):
    """(jax_dev, jax_log, port_dev, port_log) over fresh devices."""
    jdev = JaxPMEM(device_size(cap), mode=mode)
    tdev = PMEMDevice(device_size(cap), mode=mode)
    jlog = JaxLog.create(jdev, JaxConfig(capacity=cap, **cfg))
    tl = Log.create(tdev, LogConfig(capacity=cap, **cfg), device="cpu")
    return jdev, jlog, tdev, tl


def drive(log, waves, batched, keep=3):
    """Append the waves, reclaiming all but the newest ``keep`` records
    after every second wave so the ring wraps."""
    out = []
    for w, wave in enumerate(waves):
        if batched:
            out.extend(log.append_batch(wave))
        else:
            out.extend(log.append(p) for p in wave)
        if w % 2 == 1:
            for lsn in sorted(log._recs)[:-keep]:
                log.cleanup(lsn)
    return out


def waves_for(seed, n_waves=8):
    rng = np.random.default_rng(seed)
    return [[payload_for(seed * 1000 + w * 10 + i, int(rng.integers(0, 420)))
             for i in range(int(rng.integers(1, 6)))]
            for w in range(n_waves)]


def assert_same_log(jdev, jlog, tdev, tl):
    assert tdev.read(0, tdev.size) == jdev.read(0, jdev.size)
    assert durable(tdev) == durable(jdev)
    assert stats(tdev) == stats(jdev)
    assert rec_shape(tl) == rec_shape(jlog)
    assert tl.force_vns_total == jlog.force_vns_total
    # depth_bdp is AckRateEstimator.bdp_rounds(): a ratio of two
    # time.monotonic() averages, so it is held to its range on each side;
    # the port's force counters (calls past the frequency filter and their
    # host seconds) have no JAX twin; every other field must be equal
    port, ref = tl.stats(), jlog.stats()
    for side in (port, ref):
        bdp = side.pop("depth_bdp")
        assert bdp is None or bdp >= 1
    assert port.pop("forces") >= 0 and port.pop("force_s") >= 0.0
    assert port == ref


@pytest.mark.parametrize("threshold", [None, 256])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("mode", ["strict", "fast"])
def test_append_sequences_match_jax(mode, batched, threshold):
    jdev, jlog, tdev, tl = pair(mode, phash_threshold=threshold)
    waves = waves_for(3 + batched)
    assert drive(tl, waves, batched) == drive(jlog, waves, batched)
    assert_same_log(jdev, jlog, tdev, tl)
    appended = sum((REC_HDR_SIZE + len(p) + 7) & ~7 for w in waves for p in w)
    assert appended > CAP                        # the ring wrapped
    assert dict(tl.iter_records()) == dict(jlog.iter_records())


def test_scalar_complete_matches_jax_with_phash():
    jdev, jlog, tdev, tl = pair("strict", phash_threshold=64)
    for log in (jlog, tl):
        for i, size in enumerate([10, 64, 300, 0, 65]):
            rid, _ = log.reserve(size)
            log.copy(rid, payload_for(i, size))
            log.complete(rid)
            log.force(rid, freq=2)
    assert_same_log(jdev, jlog, tdev, tl)
    flags = [_REC_HDR.unpack(tdev.read(r.off, REC_HDR_SIZE))[3]
             for r in tl._recs.values()]
    assert [bool(f & FLAG_PHASH) for f in flags] == \
        [False, True, True, False, True]


def test_batch_wave_hashes_in_one_call(monkeypatch):
    calls = []
    real = tlog.tensor_checksum_batch

    def counting(mat):
        calls.append(tuple(mat.shape))
        return real(mat)

    monkeypatch.setattr(tlog, "tensor_checksum_batch", counting)
    _, jlog, tdev, tl = pair("fast", phash_threshold=256)
    wave = [payload_for(i, s) for i, s in enumerate([300, 10, 1000, 256])]
    tl.append_batch(wave)
    jlog.append_batch(wave)
    assert calls == [(3, 3 + 1000 // 4)]          # one call for the wave
    assert tdev.read(0, tdev.size) == jlog.dev.read(0, jlog.dev.size)
    calls.clear()
    relog = Log.open(tdev, LogConfig(capacity=CAP), device="cpu")
    assert len(calls) == 1                        # one call for the scan
    assert [p for _, p in relog.iter_records()] == wave
    assert len(calls) == 2


@pytest.mark.parametrize("threshold", [None, 256])
def test_images_open_in_the_other_package(threshold):
    jdev, jlog, tdev, tl = pair("strict", phash_threshold=threshold)
    waves = waves_for(7)
    drive(jlog, waves, batched=True)
    drive(tl, waves, batched=False)
    # JAX-written image, opened by the port
    t_from_j = Log.open(to_port(jdev), LogConfig(capacity=CAP), device="cpu")
    assert dict(t_from_j.iter_records()) == dict(jlog.iter_records())
    # port-written image, opened by the JAX package
    j_from_t = JaxLog.open(to_jax(tdev), JaxConfig(capacity=CAP))
    assert dict(j_from_t.iter_records()) == dict(tl.iter_records())
    assert rec_shape(j_from_t) == rec_shape(
        Log.open(tdev, LogConfig(capacity=CAP), device="cpu"))


@pytest.mark.parametrize("victim", [2, 5, 9])
def test_corrupt_phash_payload_truncates_at_same_lsn(victim):
    jdev, jlog, tdev, tl = pair("fast", phash_threshold=64)
    sizes = [32, 100, 64, 200, 16, 300, 70, 90, 128, 80]
    for log in (jlog, tl):
        log.append_batch([payload_for(i, s) for i, s in enumerate(sizes)])
        rec = log._recs[victim]
        log.dev.corrupt(rec.off + REC_HDR_SIZE, rec.size,
                        np.random.default_rng(victim))
    jre = JaxLog.open(jdev, JaxConfig(capacity=CAP))
    tre = Log.open(tdev, LogConfig(capacity=CAP), device="cpu")
    assert tre.next_lsn == jre.next_lsn == victim
    assert dict(tre.iter_records()) == dict(jre.iter_records())
    # a corruption after recovery surfaces from iter_records in both
    for log in (jre, tre):
        rec = log._recs[victim - 1]
        log.dev.corrupt(rec.off + REC_HDR_SIZE, rec.size,
                        np.random.default_rng(1))
    with pytest.raises(CorruptLogError):
        list(tre.iter_records())


def recovered_state(log):
    return (log._next_lsn, log._tail_off, log._used, log._head_lsn,
            log._head_off, rec_shape(log))


def planner_inputs(log, raw):
    """The handoff state the prefix walk leaves for the vectorized plan."""
    s = log.read_superline()
    plan, handoff = log._walk_chain(raw, s.head_off, s.head_lsn, 0,
                                    stop_lsn=max(s.head_lsn, _LSN_VEC_MIN))
    return plan, handoff


@pytest.mark.parametrize("seed", range(6))
def test_vectorized_plan_equals_walk_and_jax_plan(seed):
    jdev, jlog, tdev, tl = pair("strict", phash_threshold=256)
    waves = waves_for(seed, n_waves=14)
    drive(jlog, waves, batched=True)
    drive(tl, waves, batched=True)
    js = jdev.crash(np.random.default_rng(seed), keep_probability=0.5)
    ts = tdev.crash(np.random.default_rng(seed), keep_probability=0.5)
    tre = Log(ts, LogConfig(capacity=CAP), device="cpu")
    jre = JaxLog(js, JaxConfig(capacity=CAP))
    raw = tre._ring_snapshot()
    assert raw.dtype == torch.uint8 and raw.numel() == CAP
    plan, handoff = planner_inputs(tre, raw)
    if handoff and plan.tail % 8 == 0:
        vec = tre._plan_scan_vectorized(raw, plan.tail, plan.next_lsn,
                                        plan.used)
        walk, _ = tre._walk_chain(raw, plan.tail, plan.next_lsn, plan.used)
        jvec = jre._plan_scan_vectorized(raw.numpy().tobytes(), plan.tail,
                                         plan.next_lsn, plan.used)
        assert (vec is None) == (jvec is None)
        if vec is not None:
            assert (vec.recs, vec.tail, vec.used, vec.next_lsn) == \
                (walk.recs, walk.tail, walk.used, walk.next_lsn)
            assert vec.recs == jvec.recs
    assert recovered_state(Log.open(ts, LogConfig(capacity=CAP),
                                    device="cpu")) == \
        recovered_state(JaxLog.open(js, JaxConfig(capacity=CAP)))


def test_vectorized_plan_covers_a_long_chain_with_wraps():
    _, _, tdev, tl = pair("fast", phash_threshold=256)
    waves = [[payload_for(w * 10 + i, 24 + 16 * i) for i in range(5)]
             for w in range(30)]
    drive(tl, waves, batched=True, keep=16)
    raw = tl._ring_snapshot()
    plan, handoff = planner_inputs(tl, raw)
    assert handoff and plan.next_lsn >= _LSN_VEC_MIN
    vec = tl._plan_scan_vectorized(raw, plan.tail, plan.next_lsn, plan.used)
    walk, _ = tl._walk_chain(raw, plan.tail, plan.next_lsn, plan.used)
    assert len(vec.recs) > 5
    assert (vec.recs, vec.tail, vec.used, vec.next_lsn) == \
        (walk.recs, walk.tail, walk.used, walk.next_lsn)


def test_masquerading_payload_falls_back_identically():
    jdev, jlog, tdev, tl = pair("fast")
    for log in (jlog, tl):
        for i in range(20):
            log.append(payload_for(i, 8))
        log.append(struct.pack("<Q", 23))      # a duplicate candidate
        log.append(b"x" * 8)
        log.append(b"y" * 8)
    jre = JaxLog.open(jdev, JaxConfig(capacity=CAP))
    tre = Log.open(tdev, LogConfig(capacity=CAP), device="cpu")
    assert recovered_state(tre) == recovered_state(jre)
    raw = tre._ring_snapshot()
    plan, _ = planner_inputs(tre, raw)
    assert tre._plan_scan_vectorized(raw, plan.tail, plan.next_lsn,
                                     plan.used) is None


# -- strict crash schedules (tests/test_crash_consistency.py) ----------- #
CRASH_CAP = 1 << 14


def crash_pair():
    jdev = JaxPMEM(CRASH_CAP + 4096, mode="strict")
    tdev = PMEMDevice(CRASH_CAP + 4096, mode="strict")
    return (jdev, JaxLog.create(jdev, JaxConfig(capacity=CRASH_CAP)),
            tdev, Log.create(tdev, LogConfig(capacity=CRASH_CAP),
                             device="cpu"))


def recover_both(jdev, tdev, seed, keep):
    js = jdev.crash(np.random.default_rng(seed), keep_probability=keep)
    ts = tdev.crash(np.random.default_rng(seed), keep_probability=keep)
    assert durable(ts) == durable(js)
    jre = JaxLog.open(js, JaxConfig(capacity=CRASH_CAP))
    tre = Log.open(ts, LogConfig(capacity=CRASH_CAP), device="cpu")
    got = dict(tre.iter_records())
    assert got == dict(jre.iter_records())
    assert recovered_state(tre) == recovered_state(jre)
    return got


@pytest.mark.parametrize("seed", range(4))
def test_forced_records_survive_crash_like_jax(seed):
    jdev, jlog, tdev, tl = crash_pair()
    written = {}
    for i in range(1, 21):
        data = payload_for(i, 8 + (i * 13) % 200)
        assert tl.append(data) == jlog.append(data) == i
        written[i] = data
    got = recover_both(jdev, tdev, seed, keep=0.1)
    assert got == written


@pytest.mark.parametrize("seed", range(4))
def test_torn_unforced_tail_recovers_same_chain(seed):
    jdev, jlog, tdev, tl = crash_pair()
    for log in (jlog, tl):
        log.append(payload_for(1, 40))
        for i in range(2, 8):
            rid, _ = log.reserve(128)
            log.copy(rid, bytes([i]) * 128)
            log.complete(rid)
            log.force(rid, freq=3)
    got = recover_both(jdev, tdev, seed, keep=0.5)
    assert got[1] == payload_for(1, 40)
    lsns = sorted(got)
    assert lsns == list(range(1, len(lsns) + 1))     # gap-free prefix


def test_superline_crash_is_atomic_like_jax():
    jdev, jlog, tdev, tl = crash_pair()
    for log in (jlog, tl):
        for i in range(1, 6):
            log.append(payload_for(i, 30))
        log.cleanup(1)
        log.cleanup(2)
    for seed in range(3):
        got = recover_both(jdev, tdev, seed, keep=0.5)
        assert set(got) >= {3, 4, 5}


def test_digest_of_recovered_payloads():
    """CRC32 digest over recovered payloads, the check chip_smoke.py
    makes at full size."""
    _, _, tdev, tl = pair("fast", phash_threshold=256)
    acked = []
    for w in range(6):
        wave = [payload_for(w * 8 + i, 300) for i in range(4)]
        tl.append_batch(wave)
        acked.extend(wave)
        for lsn in sorted(tl._recs)[:-4]:
            tl.cleanup(lsn)
    relog = Log.open(tdev, LogConfig(capacity=CAP), device="cpu")
    live = [p for _, p in relog.iter_records()]
    assert live == acked[-len(live):]
    digest = 0
    for p in live:
        digest = zlib.crc32(p, digest)
    assert digest == zlib.crc32(b"".join(acked[-len(live):]))


# -- the fig5 micro-benchmark's DeviceStats contract --------------------- #
FIG5_STATS = ("writes", "bytes_written", "flushes", "lines_flushed", "fences")


def fig5_stats(make_dev, make_log, mode, batch):
    """BENCH_fig5's workload (2000 x 64 B records, sync force) on a 1 MiB
    ring: its DeviceStats and modelled vns do not depend on the ring's
    size while it does not wrap."""
    cap = 1 << 20
    dev = make_dev(device_size(cap), mode=mode)
    wal = make_log(dev, cap)
    vns = 0.0
    if batch:
        for _ in range(2000 // batch):
            vns += wal.append_batch_timed([b"x" * 64] * batch)[1]
    else:
        for _ in range(2000):
            vns += wal.append_timed(b"x" * 64)[1]
    return {k: getattr(dev.stats, k) for k in FIG5_STATS}, vns


@pytest.mark.parametrize("batch", [None, 16, 128])
@pytest.mark.parametrize("mode", ["strict", "fast"])
def test_fig5_stats_contract_matches_jax(mode, batch):
    import json
    from pathlib import Path
    got = fig5_stats(PMEMDevice, lambda d, c: Log.create(
        d, LogConfig(capacity=c), device="cpu"), mode, batch)
    want = fig5_stats(JaxPMEM, lambda d, c: JaxLog.create(
        d, JaxConfig(capacity=c)), mode, batch)
    assert got == want
    if batch is None:
        meta = json.loads((Path(__file__).resolve().parents[1]
                           / "BENCH_fig5.json").read_text())["meta"]
        assert got[0] == meta["expected_stats"][mode]
