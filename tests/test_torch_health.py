"""The port's self-healing lifecycle (core/health.py, core/cluster.py)
against the JAX package's, on the CPU.

Both packages build the same replica set, take the same appends and the
same seeded media damage (``PMEMDevice.corrupt`` draws from a numpy
generator in both), then scrub, resync and fail over.  Every integer the
two report is compared with ==: ScrubReport fields, the corrupt record
sets, ResyncReport bytes, detector and cluster counters, epochs, the
repaired images and DeviceStats.  The modelled vns are held equal too:
both packages add the same cost-model terms in the same order.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import health as jhealth
from repro.core.log import ring_offset
from repro_torch.core import health as thealth

from torch_parity import dev_kw, on_both, stats

CAP = 1 << 14


def make_rs(core, n_backups=2, wq=None, depth=2, mode="strict", cap=CAP,
            phash=None):
    """tests/test_health.py's replica set; ``phash`` lowers the log's
    phash_threshold so payloads of that many bytes or more carry the
    lane-polynomial hash (the kernel's records) instead of CRC32."""
    rs = core.build_replica_set(mode="local+remote", capacity=cap,
                                n_backups=n_backups, write_quorum=wq,
                                device_mode=mode, pipeline_depth=depth,
                                **dev_kw(core))
    if phash is not None:
        rs.log.cfg.phash_threshold = phash
    return rs


def fill(core, rs, n=12, size=48, freq=2):
    """n records; sizes alternate between ``size`` and 3·size so a lowered
    phash_threshold mixes CRC32 and hashed records."""
    pol = core.FreqPolicy(freq)
    lsns = []
    for i in range(n):
        lsn = rs.log.append(bytes([(i * 37 + 11) & 0xFF])
                            * (size * (1 + 2 * (i % 2))))
        pol.on_complete(rs.log, lsn)
        lsns.append(lsn)
    pol.drain(rs.log)
    rs.group.drain(timeout=5.0)
    return lsns


def corrupt_payload(dev, log, lsn, rng, nbits=8):
    rec = log._recs[lsn]
    before = dev.read(rec.off, rec.extent)
    dev.corrupt(rec.off + 24, rec.size, rng, nbits=nbits)
    return dev.read(rec.off, rec.extent) != before


def images(rs):
    n = ring_offset() + rs.cfg.capacity
    out = {rs.primary_id: rs.primary_dev.read(0, n)}
    out.update({s.server_id: s.device.read(0, n) for s in rs.servers})
    return out


def llc_merged(dev):
    """DeviceStats with the LLC hits and misses summed: with W < N a round
    returns at the W-th ack, and a straggler lane's read of the primary
    may land before or after the local flush (the W-th-ack race, in both
    packages)."""
    st = stats(dev)
    st["llc_hits"] += st.pop("llc_misses")
    return st


def report(rep):
    """A report's fields, corrupt_records as a set (its order within a
    copy follows each package's set iteration)."""
    d = dataclasses.asdict(rep)
    if "corrupt_records" in d:
        d["corrupt_records"] = set(map(tuple, d["corrupt_records"]))
    return d


# --------------------------------------------------------------------- #
# _bad_ordinals: one validation pass == the reference's pass per hit
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n_bad", [0, 1, 5, 17])
def test_bad_ordinals_is_the_references_set_from_one_pass(n_bad):
    """The scrubber's items over a ring image with ``n_bad`` damaged
    payloads (CRC32 and hashed records both): the port's one-pass set
    equals the reference's re-run-past-each-hit set, and both equal the
    records whose bytes actually changed."""
    rs = make_rs(jcore, n_backups=1, phash=64, cap=1 << 16)
    try:
        lsns = fill(jcore, rs, n=40)
        dev = rs.primary_dev
        rng = np.random.default_rng(100 + n_bad)
        hit = sorted(rng.choice(len(lsns), n_bad, replace=False).tolist())
        changed = {i for i in hit
                   if corrupt_payload(dev, rs.log, lsns[i], rng, nbits=3)}
        raw = dev.read(0, ring_offset() + CAP * 4)
        items = []
        for i, lsn in enumerate(lsns):
            r = rs.log._recs[lsn]
            hl, hs, hc, hf = jcore.log._REC_HDR.unpack_from(raw, r.off)
            items.append((i, r.off, lsn, r.size, hc, hf))
        flags = {it[5] & jcore.log.FLAG_PHASH for it in items}
        assert flags == {0, jcore.log.FLAG_PHASH}
        want = jhealth._bad_ordinals(raw, items)
        got = thealth._bad_ordinals(
            torch.frombuffer(bytearray(raw), dtype=torch.uint8), items,
            torch.device("cpu"))
        assert got == want == changed
    finally:
        rs.shutdown()


# --------------------------------------------------------------------- #
# the scrubber
# --------------------------------------------------------------------- #
def scrub_scenario(kind):
    """tests/test_health.py's scrub scenarios, returning everything the
    pass reports plus the images and DeviceStats after it."""
    def run(core):
        wq = 2 if kind == "unrepairable" else None
        rs = make_rs(core, n_backups=1 if kind == "unrepairable" else 2,
                     wq=wq, phash=64)
        try:
            lsns = fill(core, rs, n=16)
            rng = np.random.default_rng(7)
            cfg = None
            if kind == "bit_rot":          # both record kinds, two copies
                for i in (1, 3, 6, 11):
                    assert corrupt_payload(rs.servers[0].device, rs.log,
                                           lsns[i], rng)
                assert corrupt_payload(rs.primary_dev, rs.log, lsns[9], rng)
            elif kind == "header":
                rec = rs.log._recs[lsns[5]]
                rs.servers[1].device.write(rec.off, b"\xff" * 8)
                rs.servers[1].device.persist(rec.off, 8)
                assert corrupt_payload(rs.servers[0].device, rs.log,
                                       lsns[5], rng)
            elif kind == "unrepairable":
                assert corrupt_payload(rs.primary_dev, rs.log, lsns[4], rng)
                assert corrupt_payload(rs.servers[0].device, rs.log,
                                       lsns[4], rng)
                assert corrupt_payload(rs.servers[0].device, rs.log,
                                       lsns[8], rng)
            elif kind == "tombstone":
                rs.log.cleanup(lsns[2])
                rs.group.drain(timeout=5.0)
                rec = rs.log._recs.get(lsns[2])
                if rec is not None:
                    rs.servers[0].device.corrupt(rec.off + 24, rec.size,
                                                 rng, nbits=8)
                assert corrupt_payload(rs.servers[1].device, rs.log,
                                       lsns[3], rng)
            elif kind == "byte_budget":
                assert corrupt_payload(rs.servers[0].device, rs.log,
                                       lsns[-2], rng)
                cfg = core.ScrubConfig(max_bytes_per_pass=900)
            elif kind == "vns_budget":
                assert corrupt_payload(rs.servers[0].device, rs.log,
                                       lsns[5], rng)
                cfg = core.ScrubConfig(max_vns_per_pass=150.0)
            sc = core.Scrubber.from_replica_set(rs, cfg=cfg)
            if cfg is None:
                reps = [sc.scrub_once(), sc.scrub_once()]
            else:
                reps = sc.scrub_to_completion(max_passes=64)
            return ([report(r) for r in reps], sc.stats(), images(rs),
                    {n: llc_merged(d) for n, d in rs.server_devices().items()},
                    rs.log.timeline.clocks().get("scrub"))
        finally:
            rs.shutdown()
    return run


@pytest.mark.parametrize("kind", ["bit_rot", "header", "unrepairable",
                                  "tombstone", "byte_budget", "vns_budget"])
def test_scrub_reports_and_repairs_match_jax(kind):
    got, want = on_both(scrub_scenario(kind))
    assert got == want
    reps = got[0]
    if kind == "bit_rot":
        assert reps[0]["corrupt"] == reps[0]["repaired"] == 5
        assert reps[1]["corrupt"] == 0 and reps[1]["complete"]
    if kind == "unrepairable":
        assert reps[0]["unrepairable"] == 2 and reps[0]["repaired"] == 1
    if kind.endswith("budget"):
        assert len(reps) > 2 and got[1]["repaired"] == 1


def test_scrub_thread_mode_and_deferral_match_jax():
    """A busy load signal defers a pass; force=True overrides it."""
    def run(core):
        rs = make_rs(core)
        try:
            fill(core, rs)
            sc = core.Scrubber(rs.log, copies={"node0": rs.primary_dev},
                               load_signal=lambda: True)
            a = report(sc.scrub_once())
            b = report(sc.scrub_once(force=True))
            return a, b, sc.stats()
        finally:
            rs.shutdown()
    got, want = on_both(run)
    assert got == want and got[0]["deferred"] and got[1]["complete"]


# --------------------------------------------------------------------- #
# online resync
# --------------------------------------------------------------------- #
def resync_row(core):
    """benchmarks/ci_bench.py::fig7_resync_run (BENCH_fig7.json's
    fig7/resync/online row): 96 x 1 KiB records, node1 dies mid-wire, 96
    more at W = 2, then an online rejoin."""
    rs = core.build_replica_set(mode="local+remote", capacity=1 << 20,
                                n_backups=2, write_quorum=2,
                                pipeline_depth=4, **dev_kw(core))
    try:
        payload = b"y" * 1024
        for _ in range(96):
            rs.log.append(payload)
        rs.kill_backup_midwire("node1")
        for _ in range(96):
            rs.log.append(payload)
        rep = rs.recover_backup("node1")
        rs.log.drain()
        rs.group.drain()
        full = ring_offset() + rs.cfg.capacity
        ring = rs.primary_dev.read(0, full)
        node1 = next(s for s in rs.servers if s.server_id == "node1")
        return (dataclasses.asdict(rep), rep.repair_bytes,
                round(rep.repair_bytes / full, 4),
                node1.device.read(0, full) == ring)
    finally:
        rs.shutdown()


def test_resync_matches_jax_and_the_fig7_row():
    got, want = on_both(resync_row)
    assert got == want
    assert got[1:] == (100864, 0.0962, True)
    assert got[0]["catchup_ranges"] == 1 and got[0]["cutover_bytes"] == 0


def test_resync_of_an_in_sync_backup_ships_nothing():
    def run(core):
        rs = make_rs(core, wq=2)
        try:
            fill(core, rs, n=6)
            return dataclasses.asdict(rs.recover_backup("node2"))
        finally:
            rs.shutdown()
    got, want = on_both(run)
    assert got == want and got["catchup_bytes"] == got["cutover_bytes"] == 0


# --------------------------------------------------------------------- #
# failure detector, cluster manager, degraded quorum
# --------------------------------------------------------------------- #
def cluster_for(core, rs, **attach):
    nodes = [core.Node("node0", server=None)] + \
        [core.Node(s.server_id, server=s) for s in rs.servers]
    cm = core.ClusterManager(nodes)
    if attach:
        cm.attach_group(rs.group, **attach)
    return cm


def detector_backoff(core):
    """tests/test_health.py's backoff scenario with jitter on (seed 5):
    the probe schedule, every delay drawn from the seeded jitter stream,
    the resync on rejoin and the counters."""
    rs = make_rs(core, wq=2)
    try:
        fill(core, rs, n=6)
        cm = cluster_for(core, rs, allow_degraded=True, min_write_quorum=1)
        det = core.FailureDetector(cm, core.HeartbeatConfig(
            interval_s=0.01, miss_threshold=2, backoff_base_s=0.1,
            backoff_max_s=0.8, jitter=0.25, seed=5))
        for t in rs.transports:
            det.register_transport(t)
        resynced = []
        det.on_up(lambda nid: resynced.append(
            dataclasses.asdict(rs.recover_backup(nid))))
        rs.transports[0].inject(drop=True)
        now, evs, dues = 0.0, [], []
        for _ in range(3):
            evs += det.tick(now)
            now += 0.02
        st = det._state["node1"]
        for _ in range(5):
            now = st.next_due
            evs += det.tick(now)
            dues.append(st.next_due - now)
        rs.transports[0].inject()
        evs += det.tick(st.next_due)
        return (evs, dues, resynced, det.stats(), cm.stats(),
                sorted(cm.alive_nodes()), rs.group.write_quorum)
    finally:
        rs.shutdown()


def test_detector_schedule_and_rejoin_match_jax():
    got, want = on_both(detector_backoff)
    assert got == want
    evs, dues = got[0], got[1]
    assert evs == [("down", "node1"), ("up", "node1")]
    assert dues != pytest.approx([0.2, 0.4, 0.8, 0.8, 0.8])   # jittered


def degraded(core):
    """W = 3, node1 fails under allow_degraded (min 2), writes go on at
    W = 2, node1 resyncs and rejoins: W back to 3; then a strict cluster
    and the floor."""
    out = []
    rs = make_rs(core, wq=3)
    try:
        fill(core, rs, n=4)
        cm = cluster_for(core, rs, allow_degraded=True, min_write_quorum=2)
        rs.fail_backup("node1")
        cm.report_failure("node1")
        out += [cm.stats(), rs.group.write_quorum]
        rs.log.append(b"degraded-write" * 2)
        out.append(rs.log.durable_lsn)
        rs.transports[0].inject()
        out.append(dataclasses.asdict(rs.recover_backup("node1")))
        cm.report_recovery("node1")
        rs.log.append(b"full-quorum" * 2)
        out += [cm.stats(), rs.group.write_quorum, rs.log.durable_lsn]
    finally:
        rs.shutdown()
    rs = make_rs(core, wq=3)
    try:
        cm = cluster_for(core, rs, allow_degraded=True, min_write_quorum=2)
        cm.report_failure("node1")
        cm.report_failure("node2")
        out += [cm.stats(), rs.group.write_quorum]
    finally:
        rs.shutdown()
    return out


def test_degraded_quorum_and_floor_match_jax():
    got, want = on_both(degraded)
    assert got == want
    assert got[1] == 2 and got[2] == 5 and got[5:7] == [3, 6]
    assert got[-1] == 2


def failover_scenarios(core):
    """tests/test_force_pipeline.py's two cluster scenarios: a failover
    drains the pipeline before the epoch fence, and the drain keeps a
    deferred round error for the log's own next drain."""
    out = []
    rs = core.build_replica_set(mode="local+remote", capacity=1 << 16,
                                n_backups=2, write_quorum=2,
                                pipeline_depth=4, **dev_kw(core))
    try:
        cm = cluster_for(core, rs)
        cm.attach_log(rs.log)
        for t in rs.transports:
            t.inject(delay_s=0.1)
        pol = core.FreqPolicy(2, wait=False)
        for i in range(8):
            rid, ptr = rs.log.reserve(8)
            ptr[:] = bytes([i]) * 8
            rs.log.complete(rid)
            pol.on_complete(rs.log, rid)
        out.append(cm.report_failure("node0"))
        out += [rs.log.stats()["inflight_rounds"], rs.log.durable_lsn,
                cm.stats(), [sorted(s._fenced) for s in rs.servers]]
        rs.group.drain()
    finally:
        rs.shutdown()
    rs = core.build_replica_set(mode="local+remote", capacity=1 << 16,
                                n_backups=2, write_quorum=3,
                                pipeline_depth=2, **dev_kw(core))
    try:
        cm = cluster_for(core, rs)
        cm.attach_log(rs.log)
        rs.log.append(b"w")
        rs.fail_backup("node1")
        rid, ptr = rs.log.reserve(8)
        ptr[:] = b"z" * 8
        rs.log.complete(rid)
        rs.log.force(rid, wait=False)
        rs.log.drain(timeout=5.0, surface_errors=False)
        out.append(cm.report_failure("node0"))
        with pytest.raises(core.QuorumError):
            rs.log.drain(timeout=5.0)
        out += [cm.stats(), rs.log.durable_lsn]
    finally:
        rs.shutdown()
    return out


def test_cluster_failover_epochs_and_stats_match_jax():
    got, want = on_both(failover_scenarios)
    assert got == want
    assert got[0] == "node1" and got[1:3] == [0, 8]


# --------------------------------------------------------------------- #
# the monitor: detector + scrubber + resync on one virtual clock
# --------------------------------------------------------------------- #
def monitor(core):
    """tests/test_health.py's full monitor lifecycle: a partitioned
    backup fails over to W = 2, writes go on, the node returns, is
    resynced and restores W = 3, and the scrubber repairs bit rot in
    between."""
    rs = make_rs(core, wq=3, cap=1 << 16, phash=64)
    try:
        lsns = fill(core, rs, n=8)
        hm = rs.attach_health(allow_degraded=True, min_write_quorum=2,
                              heartbeat=core.HeartbeatConfig(
                                  interval_s=0.01, miss_threshold=2,
                                  backoff_base_s=0.05, backoff_max_s=0.2,
                                  jitter=0.0))
        rng = np.random.default_rng(23)
        assert corrupt_payload(rs.servers[1].device, rs.log, lsns[2], rng)
        assert corrupt_payload(rs.servers[1].device, rs.log, lsns[3], rng)
        now, evs, wq = 0.0, [], []
        rs.transports[0].inject(drop=True)
        for _ in range(8):
            evs += hm.tick(now)
            now += 0.02
        wq.append(rs.group.write_quorum)
        fill(core, rs, n=4)
        rs.transports[0].inject()
        for _ in range(20):
            evs += hm.tick(now)
            now += 0.1
        wq.append(rs.group.write_quorum)
        rs.log.drain(timeout=5.0)
        rs.group.drain(timeout=5.0)
        st = hm.stats()
        return evs, wq, st["detector"], st["cluster"], \
            {k: v for k, v in st["scrub"].items()
             if k not in ("passes", "deferred")}, images(rs)
    finally:
        rs.shutdown()


def test_health_monitor_lifecycle_matches_jax():
    """Scrub passes that find the engine busy are deferred, and whether a
    tick finds it busy is a race in both packages, so the pass and
    deferral counts are left out; what the passes found and repaired is
    compared, with everything else."""
    got, want = on_both(monitor)
    assert got == want
    evs, wq, det, cl, sc, imgs = got
    assert ("down", "node1") in evs and ("up", "node1") in evs
    assert wq == [2, 3] and sc["repaired"] == 2
    assert len(set(imgs.values())) == 1
