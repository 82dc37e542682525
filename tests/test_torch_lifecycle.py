"""The port's checkpoint + trim lifecycle (core/lifecycle.py) and the log
rows of the benchmark records that no earlier port test held, against the
JAX package on the CPU: BENCH_fig7.json's lifecycle rows, BENCH_fig8.json's
force-policy rows and BENCH_fig6.json's salvage row.

Integers are compared with ==, on both packages and against the recorded
rows; so are the modelled times the rows round to three decimals.
"""

import dataclasses
import json
import pathlib
import threading
import zlib

import numpy as np
import pytest

import repro_torch.core as tcore
from repro.checkpoint import manager as jmanager, store as jstore
from repro_torch.checkpoint import manager as tmanager, store as tstore

from torch_parity import dev_kw, durable, hold_until_fenced, \
    lane_acked_all, on_both, stats, wait_until

ROOT = pathlib.Path(__file__).resolve().parents[1]


def bench_rows(name):
    return json.loads((ROOT / name).read_text())["rows"]


# --------------------------------------------------------------------- #
# BENCH_fig7.json: recovery after periodic trims (O(tail), not O(ring))
# --------------------------------------------------------------------- #
LIFE_CAP = 1 << 20


def life_payload(lsn):
    return bytes([(lsn * 37 + 11) & 0xFF]) * 1024


def lifecycle_row(core, n):
    """benchmarks/ci_bench.py::fig7_lifecycle_run's trimmed service: the
    history of ``n`` 1 KiB records through a 1 MiB ring, trimmed to the
    newest 64 whenever the ring is more than half full, then reopened.
    ``n`` is the row's ``total_records``, the count a ring of age x 1 MiB
    holds (the untrimmed ring that counts it is not built here: rings in
    these tests stay at 1 MiB)."""
    cfg = core.LogConfig(capacity=LIFE_CAP)
    dev = core.PMEMDevice(core.device_size(LIFE_CAP), mode="fast")
    log = core.Log.create(dev, cfg, **dev_kw(core))
    trims, expect = 0, {}
    for i in range(n):
        p = life_payload(i + 1)
        expect[log.append(p)] = p
        if log.stats()["used"] > 0.5 * LIFE_CAP:
            log.trim(log.durable_lsn - 64)
            trims += 1
    relog = core.Log.open(dev, cfg, **dev_kw(core))
    got = dict(relog.iter_records())
    head = relog._head_lsn
    tail_exact = (sorted(got) == sorted(l for l in expect if l >= head)
                  and all(got[l] == expect[l] for l in got))
    no_resurrect = (relog.read_trim_watermark() == log.trim_lsn
                    and head == log.trim_lsn + 1
                    and (not got or min(got) == head))
    return (dict(tail_records=len(got), trims=trims, tail_exact=tail_exact,
                 trimmed_resurrected=not no_resurrect),
            durable(dev), stats(dev))


@pytest.mark.parametrize("age", [4, 16])
def test_fig7_lifecycle_rows_match_jax_and_bench(age):
    row = bench_rows("BENCH_fig7.json")[f"fig7/lifecycle/age{age}x"]
    got, want = on_both(lifecycle_row, row["total_records"])
    assert got == want
    assert got[0] == {k: row[k] for k in got[0]}
    assert (row["total_records"], got[0]["tail_records"],
            got[0]["trims"]) == {4: (4002, 72, 9), 16: (16008, 291, 36)}[age]


# --------------------------------------------------------------------- #
# LogLifecycle over the checkpoint manager
# --------------------------------------------------------------------- #
def orchestrator(core):
    """tests/test_lifecycle.py's orchestrator scenario: a manual
    checkpoint + trim, then six rings' worth of appends with the
    lifecycle attached as the free-space-low callback."""
    mgr_mod, store_mod = (tmanager, tstore) if core is tcore else \
        (jmanager, jstore)
    cap = 1 << 15
    dev = core.PMEMDevice(core.device_size(cap), mode="fast")
    log = core.Log.create(dev, core.LogConfig(capacity=cap), **dev_kw(core))
    store = store_mod.ReplicatedStore(
        [store_mod.ObjectStore("s0"), store_mod.ObjectStore("s1")],
        write_quorum=2)
    mgr = mgr_mod.CheckpointManager(store, log,
                                    mgr_mod.CheckpointConfig(keep_last=1))
    state = {"w": np.arange(64, dtype=np.float32)}
    lc = core.LogLifecycle(mgr, state_fn=lambda: state,
                           cfg=core.LifecycleConfig(free_space_low_frac=0.4)
                           ).attach()
    first = lc.checkpoint_and_trim()
    total = 0
    while total < 6 * cap:
        log.append(b"t" * 200)
        total += 200
    step, got, _ = mgr.restore({"w": np.zeros(64, dtype=np.float32)})
    lc.detach()
    reports = [{k: v for k, v in dataclasses.asdict(r).items()
                if k != "wall_s"} for r in [first] + lc.reports[1:]]
    return (reports, lc.stats(), step, np.asarray(got["w"]).tolist(),
            log.on_free_space_low is None, log.stats()["head_lsn"],
            log.read_trim_watermark())


def test_lifecycle_orchestrator_matches_jax():
    got, want = on_both(orchestrator)
    assert got == want
    reports, st = got[0], got[1]
    assert reports[0]["trigger"] == "manual" and len(reports) == st["cycles"]
    assert st["cycles"] > 1 and st["space_low_triggers"] >= 1
    assert st["full_reclaims"] == 0 and st["reclaimed_bytes"] > 4 * (1 << 15)
    assert got[3] == list(range(64)) and got[4]


def trim_replicated(core):
    """A trim on a replicated log reaches the backups' watermark slots;
    quorum recovery from the backups alone comes back at the trimmed
    head."""
    rs = core.build_replica_set(mode="local+remote", capacity=1 << 14,
                                n_backups=2, write_quorum=3,
                                **dev_kw(core))
    try:
        for i in range(40):
            rs.log.append(bytes([i]) * 48)
        vns = rs.log.trim(30)
        rs.group.drain(timeout=5.0)
        backups = {s.server_id: s.device for s in rs.servers}
        accs = [core.CopyAccessor.for_device(n, d)
                for n, d in backups.items()]
        img, rep = core.quorum_recover(accs, rs.cfg, 2, local_name="node1",
                                       **dev_kw(core))
        relog = core.Log.open(img, core.LogConfig(capacity=1 << 14),
                              **dev_kw(core))
        return (vns, [durable(d) for d in backups.values()],
                relog.read_trim_watermark(), relog._head_lsn,
                [l for l, _ in relog.iter_records()], rep.last_lsn)
    finally:
        rs.shutdown()


def test_trim_replicates_and_recovers_like_jax():
    got, want = on_both(trim_replicated)
    assert got == want
    assert got[2] == 30 and got[3] == 31 and got[4] == list(range(31, 41))


# --------------------------------------------------------------------- #
# BENCH_fig8.json: force policies x threads (modelled time, bound)
# --------------------------------------------------------------------- #
FIG8 = [("sync", {}), ("group", {"group_size": 64}), ("freq", {"freq": 8})]


def fig8_cell(core, name, kw, n_threads):
    """benchmarks/ci_bench.py::fig8_cell on a 1 MiB ring (its 1600 records
    of 256 B take 448 KB): 1600 records from ``n_threads`` threads through
    one policy, then the policy's drain."""
    cap = 1 << 20
    dev = core.PMEMDevice(core.device_size(cap))
    log = core.Log.create(dev, core.LogConfig(capacity=cap,
                                              max_threads=n_threads),
                          **dev_kw(core))
    pol = core.make_policy(name, **kw)
    per = 1600 // n_threads

    def worker():
        for _ in range(per):
            rid, ptr = log.reserve(256)
            if ptr is not None:
                ptr[:] = b"f" * 256
            log.complete(rid)
            pol.on_complete(log, rid)

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    window = log.vulnerability_window()
    force_vns = log.force_vns_total
    end = pol.drain(log)
    bound = pol.vulnerability_bound(log)
    return dict(modelled_ms=round(end * 1e-6, 3),
                modelled_work_ms=round(log.force_vns_total * 1e-6, 3),
                vulnerability_bound=bound,
                force_vns_per_record=round(force_vns / 1600, 2),
                window_within_bound=bound is None or window <= bound,
                all_durable=bool(log.durable_lsn == 1600
                                 and log.vulnerability_window() == 0))


@pytest.mark.parametrize("n_threads", [1, 8])
@pytest.mark.parametrize("name,kw", FIG8, ids=[n for n, _ in FIG8])
def test_fig8_force_policy_rows_match_jax_and_bench(name, kw, n_threads):
    """One thread: every value equals the JAX package's and the row's.
    Eight threads: which thread's record a force covers, and so the
    modelled timeline, follows the interleaving (the row's 0.279 ms for
    sync came out 0.23 in one run on the CPU); the bound is exact, and the
    timeline is held to the row's own check, never above the serial work
    sum."""
    got, want = on_both(fig8_cell, name, kw, n_threads)
    suffix = kw.get("group_size") or kw.get("freq") or ""
    row = bench_rows("BENCH_fig8.json")[
        f"fig8/policy_scaling/{name}{suffix}/{n_threads}t"]
    for side in (got, want):
        assert side["all_durable"] and side["window_within_bound"]
        assert side["vulnerability_bound"] == row["vulnerability_bound"]
        assert 0 < side["modelled_ms"] <= side["modelled_work_ms"]
    if n_threads == 1:
        assert got == want
        assert {k: got[k] for k in ("modelled_ms", "force_vns_per_record")} \
            == {k: row[k] for k in ("modelled_ms", "force_vns_per_record")}


# --------------------------------------------------------------------- #
# BENCH_fig6.json: a backup dies mid-wire under W = 3, salvage re-issues
# --------------------------------------------------------------------- #
SALVAGE_WARM, SALVAGE_RECORDS, SALVAGE_FAIL_AT, SALVAGE_FREQ = 8, 48, 24, 4


def salvage_row(core):
    """benchmarks/ci_bench.py::fig6_salvage_run on a 1 MiB ring: 8 warm
    records, then 48 x 1 KiB at depth 4 with a non-blocking freq-4 leader,
    node1 slow (30 ms) and node2 fast (2 ms); in the fault run node1 dies
    mid-wire at record 24 and rejoins at once through the online resync.
    The no-fault run is the control.

    The benchmark reaches the state its row records by the clock: when
    record 24 comes, the rounds up to LSN 24 have retired, node2 (2 ms)
    has acked the two in flight (LSNs 25-28 and 29-32) and node1 (30 ms)
    has not, and ``kill_backup_midwire`` sleeps 16 ms for node2's acks
    before it fences node1.  Here that state is waited for: node1's lane
    holds its writes of those two rounds until the fence, and the fault
    run waits until LSN 24 is durable and node2 has acked both rounds
    before it kills node1 without a settle."""
    runs = {}
    for fault in (False, True):
        rs = core.build_replica_set(mode="local+remote", capacity=1 << 20,
                                    n_backups=2, write_quorum=3,
                                    pipeline_depth=4, **dev_kw(core))
        try:
            log = rs.log
            pol = core.FreqPolicy(SALVAGE_FREQ, wait=False)
            payload = b"s" * 1024
            for _ in range(SALVAGE_WARM):
                log.append(payload)
            log.drain()
            slow, fast = rs.transports
            slow.inject(delay_s=0.03)
            fast.inject(delay_s=0.002)
            if fault:
                hold_until_fenced(slow, SALVAGE_FAIL_AT // SALVAGE_FREQ - 2)
            for i in range(SALVAGE_RECORDS):
                if fault and i == SALVAGE_FAIL_AT:
                    wait_until(lambda: log.durable_lsn == SALVAGE_WARM
                               + SALVAGE_FAIL_AT - 2 * SALVAGE_FREQ
                               and lane_acked_all(log, fast),
                               "node2's acks of the rounds in flight")
                    rs.kill_backup_midwire("node1", settle_s=0.0)
                    rs.recover_backup("node1")
                rid, ptr = log.reserve(len(payload))
                ptr[:] = payload
                log.complete(rid)
                pol.on_complete(log, rid)
            pol.drain(log)
            rs.group.drain()
            st = log.stats()
            relog = core.Log.open(rs.primary_dev,
                                  core.LogConfig(capacity=1 << 20),
                                  **dev_kw(core))
            digest, n_rec = 0, 0
            for lsn, p in relog.iter_records():
                digest = zlib.crc32(p, zlib.crc32(str(lsn).encode(), digest))
                n_rec += 1
            keys = ("writes", "bytes_written", "flushes", "lines_flushed",
                    "fences")
            runs[fault] = dict(
                digest=digest, recovered=n_rec, durable=st["durable_lsn"],
                salvage_rounds=st["salvage_rounds"],
                reissue_bytes=st["reissue_bytes"],
                failed_rounds_bytes=st["full_reissue_bytes"],
                stats={k: getattr(rs.primary_dev.stats, k) for k in keys})
        finally:
            rs.shutdown()
    f, c = runs[True], runs[False]
    return dict(
        salvage_rounds=f["salvage_rounds"], reissue_bytes=f["reissue_bytes"],
        failed_rounds_bytes=f["failed_rounds_bytes"],
        reissue_fraction=round(f["reissue_bytes"]
                               / max(f["failed_rounds_bytes"], 1), 3),
        durable_lsn=f["durable"],
        record_set_ok=f["durable"] == 56 and f["recovered"] == 56,
        digest_matches_no_fault=f["digest"] == c["digest"],
        primary_stats_match_no_fault=f["stats"] == c["stats"],
        digest=f["digest"])


def test_fig6_salvage_row_matches_jax_and_bench():
    row = bench_rows("BENCH_fig6.json")["fig6/pipelined_force/salvage"]
    got, want = on_both(salvage_row)
    assert got == want
    assert got == {k: row[k] for k in got}
    assert (got["reissue_fraction"], got["reissue_bytes"], got["digest"]) \
        == (0.5, 8384, 82838224)


# --------------------------------------------------------------------- #
# BENCH_fig7.json: local recovery of a full 16 MiB ring of 1 KiB records
# --------------------------------------------------------------------- #
FIG7_RING = 1 << 24
FIG7_STAT_KEYS = ("writes", "bytes_written", "flushes", "lines_flushed",
                  "fences", "llc_misses", "llc_hits")


def local_recovery_row(core, phash):
    """benchmarks/ci_bench.py::fig7_run without its clocks: the 16 MiB
    ring filled with 1 KiB records (waves of 64, then one at a time until
    full), hashed by the lane polynomial from 256 B (``phash``) or by
    CRC32, then reopened and replayed.  -> the row's integers, the
    recovered state, a digest of the records, the durable image and the
    DeviceStats before and after the recovery."""
    cfg = core.LogConfig(capacity=FIG7_RING,
                         phash_threshold=256 if phash else None)
    dev = core.PMEMDevice(core.device_size(FIG7_RING), mode="fast")
    log = core.Log.create(dev, cfg, **dev_kw(core))
    payload = b"r" * 1024
    n = 0
    while True:
        try:
            log.append_batch([payload] * 64)
            n += 64
        except core.LogFullError:
            break
    while True:
        try:
            log.append(payload)
            n += 1
        except core.LogFullError:
            break
    before = {k: getattr(dev.stats, k) for k in FIG7_STAT_KEYS}
    relog = core.Log.open(dev, cfg, **dev_kw(core))
    digest, replayed = 0, 0
    for lsn, p in relog.iter_records():
        digest = zlib.crc32(p, zlib.crc32(str(lsn).encode(), digest))
        replayed += 1
    after = {k: getattr(dev.stats, k) for k in FIG7_STAT_KEYS}
    state = (relog._head_lsn, relog._next_lsn, relog._tail_off, relog._used)
    return (dict(records=n,
                 recovered_state_identical=(
                     relog._next_lsn - relog._head_lsn == n
                     and replayed == n),
                 stats_identical=before == after),
            state, digest, durable(dev), after)


@pytest.mark.parametrize("integrity", ["crc32", "phash"])
def test_fig7_local_recovery_rows_match_jax_and_bench(integrity):
    """The recovered record set, state and DeviceStats equal the JAX
    package's, and the row's integers (16,008 records, recovered state and
    stats identical) are the row's; wall times are not compared."""
    row = bench_rows("BENCH_fig7.json")[f"fig7/local_recovery/{integrity}"]
    got, want = on_both(local_recovery_row, integrity == "phash")
    assert got == want
    assert got[0] == {k: row[k] for k in got[0]}
    assert got[0]["records"] == 16008
