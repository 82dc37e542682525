"""The port's primitives, transport lanes and force policies against the
JAX package's, on the CPU.

The scenarios of tests/test_primitives.py and tests/test_quorum_fastpath.py
run through both packages on the same inputs: modelled vns, ack results,
transport op counts, device images and DeviceStats must be equal, and
crash / corruption outcomes of the integrity and atomicity primitives
must be the same under the same numpy seeds.
"""

import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as tcore
from repro.core.log import ring_offset as jax_ring_offset
from repro_torch.core.log import ring_offset

from torch_parity import durable, stats

CORES = (("jax", jcore, {}), ("port", tcore, {"device": "cpu"}))


def both(fn):
    """fn(core, device_kw) run on both packages -> (jax result, port result)."""
    return tuple(fn(core, kw) for _, core, kw in CORES)


def test_ring_offsets_agree():
    assert ring_offset() == jax_ring_offset()


def test_persist_moves_volatile_units_like_jax():
    def run(core, _):
        dev = core.PMEMDevice(4096, mode="strict")
        dev.write(100, b"hello world")
        lost = dev.crash(np.random.default_rng(0), keep_probability=0.0)
        dev.write(100, b"hello world")
        vns = core.persist(dev, 100, 11)
        kept = dev.crash(np.random.default_rng(0), keep_probability=0.0)
        return (lost.read(100, 11), kept.read(100, 11), vns,
                dev.dirty_units(), stats(dev))
    j, t = both(run)
    assert t == j and t[1] == b"hello world"


@pytest.mark.parametrize("ordering", jcore.ORDERINGS)
def test_write_and_force_orderings_match_jax(ordering):
    def run(core, kw):
        rs = core.build_replica_set(mode="local+remote", capacity=1 << 16,
                                    n_backups=2, write_quorum=3, **kw)
        try:
            dev, off = rs.primary_dev, rs.log.ring_off
            dev.write(off, b"payload!" * 16)
            vns = core.write_and_force(dev, off, 128, rs.group, ordering)
            rs.group.drain()
            return (vns, stats(dev),
                    [(s.device.read(0, s.device.size), stats(s.device))
                     for s in rs.servers])
        finally:
            rs.shutdown()
    j, t = both(run)
    assert t == j


def test_ordering_costs_match_jax():
    """Fig. 6a: the same modelled cost per ordering in both packages, and
    replicate-first is the cheapest."""
    def run(core, kw):
        times = {}
        for ordering in core.ORDERINGS:
            rs = core.build_replica_set(mode="local+remote",
                                        capacity=1 << 16, n_backups=1,
                                        write_quorum=2, **kw)
            try:
                dev, off = rs.primary_dev, rs.log.ring_off
                total = 0.0
                for _ in range(20):
                    dev.write(off, b"z" * 1024)
                    total += core.write_and_force(dev, off, 1024, rs.group,
                                                  ordering)
                times[ordering] = total
            finally:
                rs.shutdown()
        return times
    j, t = both(run)
    assert t == j
    assert t[tcore.REP_LF] < t[tcore.LF_REP] <= t[tcore.PARALLEL]


@pytest.mark.parametrize("seed", range(5))
def test_integrity_region_crash_outcomes_match_jax(seed):
    def run(core, _):
        dev = core.PMEMDevice(8192, mode="strict")
        region = core.IntegrityRegion(dev, 0, capacity=256)
        region.reliable_write(b"important data", tag=7)
        first = region.reliable_read()
        region.reliable_write(b"X" * 200, tag=9)
        survivor = dev.crash(np.random.default_rng(seed),
                             keep_probability=0.5)
        return first, core.IntegrityRegion(survivor, 0,
                                           capacity=256).reliable_read()
    j, t = both(run)
    assert t == j
    assert t[0] == (b"important data", 7)


def test_integrity_region_detects_corruption_like_jax():
    def run(core, _):
        dev = core.PMEMDevice(8192)
        region = core.IntegrityRegion(dev, 0, capacity=128)
        region.reliable_write(b"d" * 100)
        dev.corrupt(core.IntegrityRegion.HEADER_SIZE + 10, 20,
                    np.random.default_rng(0))
        return region.reliable_read(), durable(dev)
    j, t = both(run)
    assert t == j and t[0][0] is None


@pytest.mark.parametrize("n_writes", [1, 2, 5])
def test_atomic_region_crash_outcomes_match_jax(n_writes):
    def run(core, _):
        out = []
        for seed in range(6):
            for keep in (0.0, 0.3, 0.7, 1.0):
                dev = core.PMEMDevice(4096, mode="strict")
                region = core.AtomicRegion(dev, 0, size=48)
                for i in range(1, n_writes + 1):
                    region.atomic_write(bytes([i]) * 48)
                survivor = dev.crash(np.random.default_rng(seed),
                                     keep_probability=keep)
                out.append(core.AtomicRegion(survivor, 0, size=48)
                           .atomic_read())
        return out
    j, t = both(run)
    assert t == j
    values = [bytes([i]) * 48 for i in range(1, n_writes + 1)]
    assert all(v in values[-2:] for v in t) if n_writes >= 2 else True


def test_atomic_region_volatile_index_like_jax():
    def run(core, _):
        dev = core.PMEMDevice(4096)
        region = core.AtomicRegion(dev, 0, size=8, volatile_index=True)
        region.atomic_write((5).to_bytes(8, "little"))
        region.atomic_write((9).to_bytes(8, "little"))
        r2 = core.AtomicRegion(dev, 0, size=8, volatile_index=True)
        return r2.recover(chooser=lambda d: int.from_bytes(d, "little"))
    j, t = both(run)
    assert t == j and int.from_bytes(t, "little") == 9


@pytest.mark.parametrize("name,kw", [("sync", {}), ("group", {"group_size": 4}),
                                     ("freq", {"freq": 4})])
def test_policy_windows_match_jax(name, kw):
    def run(core, dkw):
        dev = core.PMEMDevice(1 << 18)
        log = core.Log.create(dev, core.LogConfig(capacity=1 << 17,
                                                  max_threads=4), **dkw)
        pol = core.make_policy(name, **kw)
        trace = []
        for i in range(13):
            rid, ptr = log.reserve(16)
            ptr[:] = bytes([i]) * 16
            log.complete(rid)
            pol.on_complete(log, rid)
            trace.append((log.durable_lsn, log.vulnerability_window()))
        pol.drain(log)
        return trace, log.durable_lsn, log.force_vns_total, stats(dev)
    j, t = both(run)
    assert t == j and t[1] == 13


def test_replicate_batch_is_one_wire_round_like_jax():
    def run(core, kw):
        rs = core.build_replica_set(mode="local+remote", capacity=1 << 16,
                                    n_backups=1, write_quorum=2, **kw)
        try:
            dev, off = rs.primary_dev, rs.log.ring_off
            dev.write(off, b"A" * 256)
            dev.write(off + 1024, b"B" * 256)
            t = rs.transports[0]
            ops = t._ops
            vns = rs.group.replicate_batch(dev, [(off, 256), (off + 1024, 256)])
            rounds = t._ops - ops
            two = (rs.group.replicate(dev, off, off, 256)
                   + rs.group.replicate(dev, off + 1024, off + 1024, 256))
            return rounds, vns, two, stats(rs.servers[0].device)
        finally:
            rs.shutdown()
    j, t = both(run)
    assert t == j and t[0] == 1 and t[1] < t[2]


def test_force_across_wrap_is_one_round_like_jax():
    def run(core, kw):
        rs = core.build_replica_set(mode="local+remote", capacity=1024,
                                    n_backups=1, write_quorum=2, **kw)
        try:
            log = rs.log
            log.append(b"a" * 200)
            log.append(b"b" * 200)
            log.cleanup(1)
            log.cleanup(2)
            rid3, v3 = log.reserve(400)
            v3[:] = b"c" * 400
            log.complete(rid3)
            rid4, v4 = log.reserve(120)       # pad, then wraps to 0
            v4[:] = b"d" * 120
            log.complete(rid4)
            t = rs.transports[0]
            ops = t._ops
            log.force(rid4)
            relog = core.Log.open(rs.servers[0].device,
                                  core.LogConfig(capacity=1024), **kw)
            return (t._ops - ops, dict(relog.iter_records()),
                    log.force_vns_total)
        finally:
            rs.shutdown()
    j, t = both(run)
    assert t == j and t[0] == 1
    assert t[1] == {3: b"c" * 400, 4: b"d" * 120}


def test_quorum_errors_and_broadcast_eviction_like_jax():
    def run(core, kw):
        out = []
        rs = core.build_replica_set(mode="local+remote", capacity=1 << 16,
                                    n_backups=2, write_quorum=3, **kw)
        try:
            rs.fail_backup("node1")
            with pytest.raises(core.QuorumError):
                rs.log.append(b"x")
        finally:
            rs.shutdown()
        rs = core.build_replica_set(mode="local+remote", capacity=1 << 16,
                                    n_backups=2, write_quorum=2, **kw)
        try:
            rs.fail_backup("node1")
            out.append(rs.group.broadcast_bytes(b"epoch!", 0))
            rs.group.drain()
            out.append([t.closed for t in rs.transports])
            rs.fail_backup("node2")
            with pytest.raises(core.QuorumError):
                rs.group.broadcast_bytes(b"epoch!!", 0)
        finally:
            rs.shutdown()
        return out
    j, t = both(run)
    assert t == j and t[1] == [True, False]


def test_straggler_lane_stays_fifo_like_jax():
    def run(core, kw):
        rs = core.build_replica_set(mode="local+remote", capacity=1 << 16,
                                    n_backups=1, write_quorum=1, **kw)
        try:
            rs.transports[0].inject(delay_s=0.01)
            acks = [rs.log.append(f"r{i}".encode()) for i in range(5)]
            rs.group.drain()
            relog = core.Log.open(rs.servers[0].device,
                                  core.LogConfig(capacity=1 << 16), **kw)
            return acks, [p for _, p in relog.iter_records()], \
                stats(rs.servers[0].device)
        finally:
            rs.shutdown()
    j, t = both(run)
    assert t == j and t[1] == [f"r{i}".encode() for i in range(5)]


def test_write_and_force_segs_stats_like_jax():
    def run(core, _):
        dev = core.PMEMDevice(1 << 16)
        dev.write(0, b"x" * 128)
        dev.write(4096, b"y" * 128)
        vns = core.write_and_force_segs(dev, [(0, 128), (4096, 128)])
        return vns, stats(dev)
    j, t = both(run)
    assert t == j and t[1]["flushes"] == 2
