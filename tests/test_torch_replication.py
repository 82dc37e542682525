"""The port's replication and quorum recovery against the JAX package's,
on the CPU.

Both packages build the quickstart/fig6 deployment (local primary + 2
backups, W = 2 of 3 copies) and take the same appends; backup images,
acks and DeviceStats must be identical.  Quorum recovery with the
primary lost must rebuild the same records with the same repair
traffic.
"""

import numpy as np
import pytest

from repro.core import (CopyAccessor as JaxAccessor, LogConfig as JaxConfig,
                        build_replica_set as jax_build,
                        quorum_recover as jax_recover)
from repro.core.log import Log as JaxLog
from repro_torch.core import (CopyAccessor, Log, LogConfig, RecoveryError,
                              build_replica_set, quorum_recover)
from repro_torch.core.log import ring_offset
from repro_torch.core.recovery import _diff_ranges

from torch_parity import payload_for, stats, to_jax

CAP = 1 << 16


def both_sets(write_quorum=2):
    jrs = jax_build(mode="local+remote", capacity=CAP, n_backups=2,
                    write_quorum=write_quorum)
    trs = build_replica_set(mode="local+remote", capacity=CAP, n_backups=2,
                            write_quorum=write_quorum, device="cpu")
    return jrs, trs


def primary_stats(rs, write_quorum):
    """The primary's DeviceStats.  With W=2 the round returns at the first
    backup ack, and the straggler lane's DMA read of the primary may land
    before or after the local flush evicts the lines: the hit/miss split
    depends on thread timing in both packages, so only its sum is
    compared."""
    st = stats(rs.primary_dev)
    if write_quorum < 3:
        st["llc_hits"] += st.pop("llc_misses")
    return st


def fill(rs, n=24, batched=False):
    acks = []
    if batched:
        for w in range(0, n, 6):
            rs.log.append_batch([payload_for(i, 50 + 31 * i)
                                 for i in range(w, w + 6)])
            acks.append(rs.log.durable_lsn)
    else:
        acks = [rs.log.append(payload_for(i, 50 + 31 * i)) for i in range(n)]
    rs.group.drain()
    return acks


@pytest.mark.parametrize("write_quorum", [2, 3])
@pytest.mark.parametrize("batched", [False, True])
def test_backups_acks_and_stats_match_jax(batched, write_quorum):
    jrs, trs = both_sets(write_quorum)
    try:
        assert fill(trs, batched=batched) == fill(jrs, batched=batched)
        size = ring_offset() + CAP
        assert trs.primary_dev.read(0, size) == jrs.primary_dev.read(0, size)
        for ts, js in zip(trs.servers, jrs.servers):
            assert ts.server_id == js.server_id
            assert ts.device.read(0, size) == js.device.read(0, size)
            assert stats(ts.device) == stats(js.device)
        assert primary_stats(trs, write_quorum) == \
            primary_stats(jrs, write_quorum)
        assert trs.log.durable_lsn == jrs.log.durable_lsn
        assert trs.log.force_vns_total == jrs.log.force_vns_total
        # each backup is a complete log, in either package
        for ts in trs.servers:
            relog = Log.open(ts.device, LogConfig(capacity=CAP),
                             device="cpu")
            jre = JaxLog.open(to_jax(ts.device), JaxConfig(capacity=CAP))
            assert dict(relog.iter_records()) == dict(jre.iter_records())
    finally:
        jrs.shutdown()
        trs.shutdown()


def test_backup_partition_keeps_quorum_like_jax():
    jrs, trs = both_sets()
    try:
        for rs in (jrs, trs):
            rs.log.append(b"a")
            rs.fail_backup("node1")
            assert rs.log.append(b"b") == 2          # W=2 of 3 still holds
            rs.group.drain()
        assert [t.closed for t in trs.transports] == \
            [t.closed for t in jrs.transports]
    finally:
        jrs.shutdown()
        trs.shutdown()


def accessors(rs, cls, include_primary):
    out = []
    for name, dev in rs.server_devices().items():
        if name == rs.primary_id and not include_primary:
            continue
        out.append(cls.for_device(name, dev))
    return out


@pytest.mark.parametrize("include_primary", [False, True])
def test_quorum_recover_matches_jax(include_primary):
    jrs, trs = both_sets()
    try:
        fill(trs, batched=True)
        fill(jrs, batched=True)
        if include_primary:
            # a lagging backup: the repair ships its missing ranges
            for rs in (jrs, trs):
                rs.fail_backup("node2")
                for i in range(5):
                    rs.log.append(payload_for(100 + i, 70))
                rs.group.drain()
        jimg, jrep = jax_recover(accessors(jrs, JaxAccessor, include_primary),
                                 jrs.cfg, write_quorum=2,
                                 local_name="node0-rebuilt")
        timg, trep = quorum_recover(
            accessors(trs, CopyAccessor, include_primary), trs.cfg,
            write_quorum=2, local_name="node0-rebuilt", device="cpu")
        assert trep.__dict__ == jrep.__dict__
        size = ring_offset() + CAP
        assert timg.read(0, size) == jimg.read(0, size)
        relog = Log.open(timg, LogConfig(capacity=CAP), device="cpu")
        jre = JaxLog.open(jimg, JaxConfig(capacity=CAP))
        assert list(relog.iter_records()) == list(jre.iter_records())
        assert relog.stats()["epoch"] == trep.new_epoch
    finally:
        jrs.shutdown()
        trs.shutdown()


def test_read_quorum_not_met_raises():
    trs = build_replica_set(mode="local+remote", capacity=CAP, n_backups=2,
                            write_quorum=2, device="cpu")   # R = 3 - 2 + 1
    try:
        trs.log.append(b"x")
        # both backups hold the record: W = 2 acks at the primary and one
        # backup, so the other may still lag (with no readable copy at all
        # both packages fail in max() with ValueError; ROADMAP Queue 3)
        trs.group.drain()
        accs = accessors(trs, CopyAccessor, include_primary=False)[:1]
        with pytest.raises(RecoveryError):
            quorum_recover(accs, trs.cfg, write_quorum=2, device="cpu")
    finally:
        trs.shutdown()


@pytest.mark.parametrize("seed", range(4))
def test_diff_ranges_match_jax(seed):
    from repro.core.recovery import _diff_ranges as jax_diff
    import torch
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 20000))
    golden = rng.integers(0, 256, n, dtype=np.uint8)
    cur = golden.copy()
    for _ in range(int(rng.integers(0, 6))):
        a = int(rng.integers(0, n))
        cur[a:a + int(rng.integers(1, 3000))] ^= 1
    assert _diff_ranges(torch.from_numpy(golden), torch.from_numpy(cur),
                        64) == jax_diff(golden, cur, 64)


def test_health_paths_name_the_slice_that_brings_them():
    """The health slice brought both paths: ``attach_health`` builds the
    health module's monitor (once), and ``recover_backup`` resyncs online
    unless asked not to."""
    from repro_torch.core.health import HealthMonitor, ResyncReport
    trs = build_replica_set(mode="local+remote", capacity=CAP, n_backups=1,
                            device="cpu")
    try:
        mon = trs.attach_health()
        assert isinstance(mon, HealthMonitor) and trs.attach_health() is mon
        rep = trs.recover_backup("node1")
        assert isinstance(rep, ResyncReport) and rep.server_id == "node1"
        assert trs.recover_backup("node1", resync=False) is None
    finally:
        trs.shutdown()


# -- the fig6 pipelined-force workload (BENCH_fig6.json) ----------------- #
def fig6_row(core, depth, adaptive=False, **dev_kw):
    """benchmarks/ci_bench.py::fig6_pipeline_run on a 1 MiB ring: 8 warm
    records, then 96 x 1 KiB records with a non-blocking freq-4 leader
    over a 4 ms injected wire, at pipeline depth ``depth`` (with
    ``adaptive``, the controller's ceiling)."""
    import zlib
    cost = core.CostModel().with_wire_rtt(4e6)
    rs = core.build_replica_set(mode="local+remote", capacity=1 << 20,
                                n_backups=2, write_quorum=2,
                                pipeline_depth=depth, adaptive_depth=adaptive,
                                cost=cost, **dev_kw)
    try:
        payload = b"p" * 1024
        pol = core.FreqPolicy(4, wait=False)
        for _ in range(8):
            rs.log.append(payload)
        rs.log.drain()
        for t in rs.transports:
            t.inject(delay_s=0.004)
        v0 = rs.log.durable_vtime
        for _ in range(96):
            rid, ptr = rs.log.reserve(len(payload))
            ptr[:] = payload
            rs.log.complete(rid)
            pol.on_complete(rs.log, rid)
        modelled_ms = round((pol.drain(rs.log) - v0) * 1e-6, 3)
        rs.group.drain()
        relog = core.Log.open(rs.primary_dev,
                              core.LogConfig(capacity=1 << 20), **dev_kw)
        digest = 0
        for lsn, p in relog.iter_records():
            digest = zlib.crc32(p, zlib.crc32(str(lsn).encode(), digest))
        backups = {s.server_id: stats(s.device) for s in rs.servers}
        return (digest, rs.log.durable_lsn, rs.log.force_vns_total, backups,
                modelled_ms, [list(p) for p in rs.log.depth_trajectory])
    finally:
        rs.shutdown()


# the spread allowed around each depth's modelled ms: the JAX package's
# own over 10 runs on the CPU (depth 2: 48.126-48.127; depth 4:
# 24.073-24.075 in earlier runs)
FIG6_SPREAD = {1: 0.0, 2: 0.001, 4: 0.005}


@pytest.mark.parametrize("depth,modelled_ms",
                         [(1, 96.244), (2, 48.126), (4, 24.073)])
def test_fig6_pipeline_row_matches_jax_and_bench(depth, modelled_ms):
    """Digest, durable watermark, modelled work and backup DeviceStats are
    exact.  The modelled time at depth > 1 depends on which straggler
    acks have landed when a round retires (QuorumRound.schedule_on leaves
    lanes still in flight unscheduled), so it varies by a few modelled
    microseconds from run to run in both packages: it is held to
    BENCH_fig6's value within the JAX package's spread there, and exactly
    at depth 1."""
    import json
    import pathlib
    import repro.core as jcore
    import repro_torch.core as tcore
    row = json.loads((pathlib.Path(__file__).resolve().parents[1]
                      / "BENCH_fig6.json").read_text())["rows"][
        f"fig6/pipelined_force/depth{depth}"]
    got = fig6_row(tcore, depth, device="cpu")
    assert got[:4] == fig6_row(jcore, depth)[:4]
    assert got[:2] == (782714043, 104) == (row["digest"], row["durable_lsn"])
    assert got[5] == [[0, depth]]
    assert modelled_ms == row["modelled_ms"]
    assert abs(got[4] - modelled_ms) <= FIG6_SPREAD[depth]


def test_fig6_adaptive_row_matches_jax_and_bench():
    """BENCH_fig6.json's adaptive row (ceiling 8): digest, durable
    watermark, modelled work and backup DeviceStats exact against the JAX
    package.  The controller reads the wall clock.  Over 50 runs of the
    JAX package on the CPU (20 interleaved with the port's on a quiet
    host) every trajectory began (0, 1), (9, 2) and then rose one step at
    a time to 8; on the quiet host both packages modelled 16.063-16.068
    ms (the row's 16.068), and under load the JAX package's ran from
    12.069 to 16.068 and the port's from 16.046 to 20.067, as the growth
    came sooner or later.  So the port's modelled time, the median of
    three runs, is held to 16.057-16.068 widened to three JAX runs made
    beside it, under the same load."""
    import json
    import pathlib
    import repro.core as jcore
    import repro_torch.core as tcore
    row = json.loads((pathlib.Path(__file__).resolve().parents[1]
                      / "BENCH_fig6.json").read_text())["rows"][
        "fig6/pipelined_force/adaptive"]
    runs = [(fig6_row(tcore, 8, adaptive=True, device="cpu"),
             fig6_row(jcore, 8, adaptive=True)) for _ in range(3)]
    for got, want in runs:
        assert got[:4] == want[:4]
        assert got[:2] == (row["digest"], row["durable_lsn"])
        for traj in (got[5], want[5]):
            assert traj[:2] == row["depth_trajectory"][:2] == [[0, 1], [9, 2]]
            assert [d for _, d in traj] == list(range(1, 9))
            seqs = [s for s, _ in traj]
            assert seqs == sorted(set(seqs))
    lo = min([16.057] + [want[4] for _, want in runs])
    hi = max([16.068] + [want[4] for _, want in runs])
    port = sorted(got[4] for got, _ in runs)[1]
    assert lo <= port <= hi, ([(g[4], w[4]) for g, w in runs], lo, hi)
    assert lo <= row["modelled_ms"] <= hi
