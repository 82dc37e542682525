"""The port's partial-quorum salvage and adaptive pipeline depth
(core/log.py, core/transport.py) against the JAX package on the CPU: the
counterparts of tests/test_salvage_adaptive.py, one port test a JAX test,
each naming the one it mirrors.

The reference's tests make their faults with clocks: a backup whose acks
come 80 ms late dies 40 ms after the stream, so the rounds in flight at
its death, and what the healthy backup had acked by then, follow the
scheduler.  Here those states are made and waited for: the dying backup's
lane holds its writes until the fence (``hold_until_fenced``), and the
kill comes once the healthy backup has acked every round in flight.  Those
scenarios then run the same on every run, and each runs on both packages
and is compared with ==.  The adaptive controller reads the wall clock
(its ack-rate estimator), so the scenarios that grow the depth are held
to the reference's invariants, on the port and on the JAX package both.
"""

import zlib

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.core as jcore
import repro_torch.core as tcore

from torch_parity import (dev_kw, hold_until_fenced, hold_writes,
                          lane_acked_all, on_both, stats, wait_until)

CAP = 1 << 16
STAT_KEYS = ("writes", "bytes_written", "flushes", "lines_flushed", "fences")
SALVAGE_KEYS = ("durable_lsn", "salvage_rounds", "reissue_bytes",
                "full_reissue_bytes", "salvage_pending",
                "salvage_spilled_images", "salvage_spilled_bytes",
                "inflight_rounds")


def rset(core, wq=3, depth=4, adaptive=False, salvage=True, n_backups=2,
         cap=CAP):
    return core.build_replica_set(mode="local+remote", capacity=cap,
                                  n_backups=n_backups, write_quorum=wq,
                                  pipeline_depth=depth,
                                  adaptive_depth=adaptive, salvage=salvage,
                                  **dev_kw(core))


def stream(log, pol, n, size=16, tag=0):
    for i in range(n):
        rid, ptr = log.reserve(size)
        data = bytes([(tag + i) & 0xFF]) * size
        if ptr is not None:
            ptr[:] = data
        else:
            log.copy(rid, data)
        log.complete(rid)
        pol.on_complete(log, rid)


def primary_stats(rs) -> dict:
    return {k: getattr(rs.primary_dev.stats, k) for k in STAT_KEYS}


def salvage_stats(log) -> dict:
    s = log.stats()
    return {k: s[k] for k in SALVAGE_KEYS}


def records(core, dev, cap=CAP) -> dict:
    relog = core.Log.open(dev, core.LogConfig(capacity=cap), **dev_kw(core))
    return {lsn: bytes(p) for lsn, p in relog.iter_records()}


def copies(core, rs, cap=CAP) -> dict:
    """Each copy's recovered records, the primary's included."""
    out = {"node0": records(core, rs.primary_dev, cap)}
    out.update({s.server_id: records(core, s.device, cap)
                for s in rs.servers})
    return out


def close(rs):
    rs.group.drain(timeout=10.0, surface_errors=False)
    rs.shutdown()


def kill_node1_midwire(rs, log):
    """node1 dies with every round in flight: its lane held each write
    since ``hold_until_fenced``; node2 has acked them all."""
    wait_until(lambda: lane_acked_all(log, rs.transports[1]),
               "node2's acks of the rounds in flight")
    rs.kill_backup_midwire("node1", settle_s=0.0)
    assert log.stats()["inflight_rounds"] == 0, "rounds never settled"


def fail_midwire_then_recover(core, rs, log, pol, n_before=8, n_after=4):
    """The reference's canonical salvage scenario: W = 3 over local + 2
    backups, node2's acks land first, node1 dies mid-wire (fenced) so
    every in-flight round fails, then node1 rejoins and the stream goes
    on.  ``n_before`` may hold at most ``2 * depth`` records: node1 lets
    no round retire before its death."""
    log.append(b"warm" * 4)
    hold_until_fenced(rs.transports[0])
    stream(log, pol, n_before)
    kill_node1_midwire(rs, log)
    if log.cfg.salvage:
        assert log.stats()["salvage_pending"] > 0, "no salvage stash built"
    rs.recover_backup("node1")
    stream(log, pol, n_after, tag=0x40)


# --------------------------------------------------------------------- #
# salvage: deltas only, nothing lost, nothing repeated
# --------------------------------------------------------------------- #
def reissue_deltas(core):
    rs = rset(core)
    try:
        log, pol = rs.log, core.FreqPolicy(2, wait=False)
        fail_midwire_then_recover(core, rs, log, pol)
        pol.drain(log)
        st = salvage_stats(log)
        log.drain(timeout=10.0)
        rs.group.drain(timeout=10.0)
        return st, copies(core, rs), primary_stats(rs), \
            {s.server_id: stats(s.device) for s in rs.servers}
    finally:
        close(rs)


def test_salvage_reissues_only_unacked_deltas():
    """test_salvage_adaptive.py::test_salvage_reissues_only_unacked_deltas"""
    got, want = on_both(reissue_deltas)
    assert got == want
    st, cps = got[0], got[1]
    assert st["durable_lsn"] == 13 and st["salvage_rounds"] >= 1
    assert 0 < st["reissue_bytes"] < st["full_reissue_bytes"], st
    assert all(len(c) == 13 for c in cps.values())
    assert len({tuple(sorted(c.items())) for c in cps.values()}) == 1


def skips_acked_backup(core):
    rs = rset(core)
    try:
        log, pol = rs.log, core.FreqPolicy(2, wait=False)
        fail_midwire_then_recover(core, rs, log, pol, n_before=7, n_after=0)
        n2_before = rs.servers[1].device.stats.bytes_written
        last = log.next_lsn - 1
        log.force(last, freq=1, timeout=10.0)
        out = (log.durable_lsn == last,
               rs.servers[1].device.stats.bytes_written - n2_before,
               salvage_stats(log))
        rs.group.drain(timeout=10.0)
        return out
    finally:
        close(rs)


def test_salvage_skips_already_acked_backup():
    """test_salvage_adaptive.py::test_salvage_skips_already_acked_backup"""
    got, want = on_both(skips_acked_backup)
    assert got == want
    assert got[0] and got[1] == 0, \
        "salvage re-sent ranges the healthy backup already acked"
    assert got[2]["reissue_bytes"] > 0


def hardware_work(core, fault):
    rs = rset(core)
    try:
        log, pol = rs.log, core.FreqPolicy(2, wait=False)
        if fault:
            fail_midwire_then_recover(core, rs, log, pol)
        else:
            log.append(b"warm" * 4)
            stream(log, pol, 8)
            stream(log, pol, 4, tag=0x40)
        pol.drain(log)
        assert log.durable_lsn == 13
        return primary_stats(rs), records(core, rs.primary_dev)
    finally:
        close(rs)


def test_salvage_adds_no_primary_hardware_work():
    """test_salvage_adaptive.py::test_salvage_adds_no_primary_hardware_work"""
    runs = {f: on_both(hardware_work, f) for f in (False, True)}
    for got, want in runs.values():
        assert got == want
    assert runs[True][0] == runs[False][0], runs


def blocking_waiter(core):
    rs = rset(core)
    try:
        log = rs.log
        log.append(b"warm")
        rs.servers[0].fence("node0")            # node1 rejects from the start
        # node2's ack of the round lands after node1's refusal fails it,
        # as the reference's 10 ms delay on node2 arranges
        hold_writes(rs.transports[1],
                    lambda: log.stats()["inflight_rounds"] == 0,
                    what="the failed round's settle")
        rid, ptr = log.reserve(16)
        ptr[:] = b"x" * 16
        log.complete(rid)
        with pytest.raises(core.QuorumError):
            log.force(rid, timeout=10.0)
        first = log.durable_lsn
        rs.recover_backup("node1")
        assert log.force(rid, timeout=10.0) == rid
        rs.group.drain(timeout=10.0)
        return first, salvage_stats(log), copies(core, rs)
    finally:
        close(rs)


def test_salvage_blocking_waiter_raises_then_retry_salvages():
    """test_salvage_adaptive.py::test_salvage_blocking_waiter_raises_then_retry_salvages"""
    got, want = on_both(blocking_waiter)
    assert got == want
    assert got[0] == 1
    assert got[1]["salvage_rounds"] == 1 and got[1]["reissue_bytes"] > 0


def retry_budget(core):
    rs = rset(core)
    try:
        log, pol = rs.log, core.FreqPolicy(1, wait=False)
        log.append(b"warm")
        rs.kill_backup_midwire("node1", settle_s=0.0)   # dies, never rejoins
        raised = []
        for i in range(16):
            rid, ptr = log.reserve(16)
            ptr[:] = bytes([i]) * 16
            log.complete(rid)
            try:
                pol.on_complete(log, rid)
            except core.QuorumError:
                raised.append(i)
            # the round each force issued settles (fails) before the next
            wait_until(lambda: log.stats()["inflight_rounds"] == 0,
                       "the failed round's settle")
        return raised, log.durable_lsn
    finally:
        close(rs)


def test_salvage_retry_budget_surfaces_permanent_failure_on_force():
    """test_salvage_adaptive.py::test_salvage_retry_budget_surfaces_permanent_failure_on_force

    Each force here waits for the round before it to fail, so which forces
    raise is fixed and is compared with the JAX package's."""
    got, want = on_both(retry_budget)
    assert got == want
    assert got[0], "permanent quorum failure never surfaced on force"
    assert got[1] == 1


def unrecovered_drain(core):
    rs = rset(core)
    try:
        log, pol = rs.log, core.FreqPolicy(2, wait=False)
        log.append(b"warm")
        rs.servers[0].fence("node0")
        stream(log, pol, 4)
        with pytest.raises(core.QuorumError):
            pol.drain(log)
        return log.durable_lsn
    finally:
        close(rs)


def test_salvage_unrecovered_backup_still_surfaces_on_drain():
    """test_salvage_adaptive.py::test_salvage_unrecovered_backup_still_surfaces_on_drain"""
    assert on_both(unrecovered_drain) == (1, 1)


def salvage_or_not(core, salvage):
    rs = rset(core, salvage=salvage)
    try:
        log, pol = rs.log, core.FreqPolicy(2, wait=False)
        fail_midwire_then_recover(core, rs, log, pol, n_after=0)
        if not salvage:
            # the deferred failure surfaces before the full re-issue
            with pytest.raises(core.QuorumError):
                log.drain(timeout=10.0)
        stream(log, pol, 4, tag=0x40)
        pol.drain(log)
        return (log.durable_lsn, records(core, rs.primary_dev),
                salvage_stats(log))
    finally:
        close(rs)


@pytest.mark.parametrize("salvage", [True, False])
def test_salvage_disabled_matches_salvaged_content(salvage):
    """test_salvage_adaptive.py::test_salvage_disabled_matches_salvaged_content"""
    got, want = on_both(salvage_or_not, salvage)
    assert got == want
    other = salvage_or_not(tcore, not salvage)
    assert got[:2] == other[:2]            # salvage never changes content
    if salvage:
        assert got[2]["salvage_rounds"] >= 1
    else:
        assert got[2]["salvage_rounds"] == got[2]["reissue_bytes"] == 0


def fatal_salvage(core):
    rs = rset(core)
    try:
        log, pol = rs.log, core.FreqPolicy(2, wait=False)
        fail_midwire_then_recover(core, rs, log, pol, n_before=7, n_after=0)
        server = rs.servers[0]
        orig = server.handle_write_imm

        def dying(dst_off, data, primary_id):
            raise ValueError("remote handler bug")     # fatal, not Transport

        server.handle_write_imm = dying
        last = log.next_lsn - 1
        with pytest.raises(ValueError):
            log.force(last, timeout=10.0)              # salvage round dies
        dropped = log.stats()["salvage_pending"]
        server.handle_write_imm = orig
        raised = []
        for _ in range(8):
            try:
                assert log.force(last, timeout=10.0) == last
                break
            except (core.QuorumError, ValueError) as e:
                raised.append(type(e).__name__)
        rs.group.drain(timeout=10.0, surface_errors=False)
        return dropped, raised, log.durable_lsn == last, copies(core, rs)
    finally:
        close(rs)


def test_fatal_salvage_failure_drops_stash_and_full_reissue_recovers():
    """test_salvage_adaptive.py::test_fatal_salvage_failure_drops_stash_and_full_reissue_recovers"""
    got, want = on_both(fatal_salvage)
    assert got == want
    dropped, raised, durable, cps = got
    assert dropped == 0, "non-salvageable failure left a partial stash"
    assert durable and len(raised) < 8
    assert all(len(c) == 8 for c in cps.values())


def tombstone_generation(core):
    rs = rset(core)
    try:
        log, pol = rs.log, core.FreqPolicy(2, wait=False)
        log.append(b"warm")
        hold_until_fenced(rs.transports[0])
        stream(log, pol, 4)                     # rounds now in flight
        with log._commit_cv:
            log._salvage_gen += 1               # tombstone races the failure
        kill_node1_midwire(rs, log)
        pending = log.stats()["salvage_pending"]
        with pytest.raises(core.QuorumError):
            log.drain(timeout=10.0)             # the failure still surfaces
        return pending, log.durable_lsn
    finally:
        close(rs)


def test_tombstone_generation_blocks_stale_wire_images():
    """test_salvage_adaptive.py::test_tombstone_generation_blocks_stale_wire_images"""
    got, want = on_both(tombstone_generation)
    assert got == want
    assert got[0] == 0, "pre-tombstone wire images were stashed for re-issue"


def cleanup_stash(core):
    rs = rset(core)
    try:
        log, pol = rs.log, core.FreqPolicy(2, wait=False)
        fail_midwire_then_recover(core, rs, log, pol, n_before=7, n_after=0)
        out = [log.stats()["salvage_pending"] > 0]
        log.cleanup(1)                          # durable warm record: no-op
        out.append(log.stats()["salvage_pending"] > 0)
        log.cleanup(3)                          # inside the failed range
        out.append(log.stats()["salvage_pending"])
        last = log.next_lsn - 1
        with pytest.raises(core.QuorumError):
            log.force(last, timeout=10.0)
        out += [log.force(last, timeout=10.0) == last,
                log.stats()["reissue_bytes"]]
        rs.group.drain(timeout=10.0)
        return out
    finally:
        close(rs)


def test_cleanup_drops_salvage_stash():
    """test_salvage_adaptive.py::test_cleanup_drops_salvage_stash"""
    got, want = on_both(cleanup_stash)
    assert got == want == [True, True, 0, True, 0]


def stash_cap(core, cap):
    rs = rset(core)
    try:
        log, pol = rs.log, core.FreqPolicy(2, wait=False)
        log.cfg.salvage_stash_cap = cap
        fail_midwire_then_recover(core, rs, log, pol, n_before=8, n_after=4)
        pol.drain(log)
        s = log.stats()
        return (s["salvage_stash_cap"], log.durable_lsn,
                records(core, rs.primary_dev), salvage_stats(log))
    finally:
        close(rs)


def test_salvage_stash_cap_spills_oldest_and_content_survives():
    """test_salvage_adaptive.py::test_salvage_stash_cap_spills_oldest_and_content_survives"""
    runs = {cap: on_both(stash_cap, cap) for cap in (None, 1)}
    for got, want in runs.values():
        assert got == want
    free, capped = runs[None][0], runs[1][0]
    assert (free[0], capped[0]) == (None, 1)
    assert capped[1:3] == free[1:3]         # a cap never changes content
    assert free[3]["salvage_spilled_images"] == 0
    assert capped[3]["salvage_spilled_images"] > 0
    assert capped[3]["salvage_spilled_bytes"] > 0
    assert capped[3]["reissue_bytes"] >= free[3]["reissue_bytes"]


def stash_bytes(core):
    cap = 64
    rs = rset(core)
    try:
        log, pol = rs.log, core.FreqPolicy(2, wait=False)
        log.cfg.salvage_stash_cap = cap
        log.append(b"warm" * 4)
        hold_until_fenced(rs.transports[0])
        stream(log, pol, 8)
        kill_node1_midwire(rs, log)
        s = log.stats()
        held = (s["salvage_pending"], s["salvage_stash_bytes"],
                s["salvage_spilled_images"])
        rs.recover_backup("node1")
        pol.drain(log)
        return held, log.durable_lsn
    finally:
        close(rs)


def test_salvage_stash_bytes_surfaced_and_bounded_by_cap():
    """test_salvage_adaptive.py::test_salvage_stash_bytes_surfaced_and_bounded_by_cap"""
    got, want = on_both(stash_bytes)
    assert got == want
    (pending, held, spilled), durable = got
    assert pending > 0 and held <= 64 and spilled > 0
    assert durable == 9                     # nothing lost to the spill


def failover_stash(core):
    rs = rset(core, wq=3)
    try:
        nodes = [core.Node("node0")] + [core.Node(s.server_id, server=s)
                                        for s in rs.servers]
        cm = core.ClusterManager(nodes)
        cm.attach_log(rs.log)
        rs.log.append(b"warm")
        rs.servers[0].fence("node0")
        # node2's acks land after node1's refusals fail each round
        hold_writes(rs.transports[1],
                    lambda: rs.log.stats()["inflight_rounds"] == 0,
                    what="the failed rounds' settle")
        stream(rs.log, core.FreqPolicy(2, wait=False), 4)
        rs.log.drain(timeout=10.0, surface_errors=False)
        before = rs.log.stats()["salvage_pending"]
        cm.report_failure("node0")
        after = rs.log.stats()["salvage_pending"]
        with pytest.raises(core.QuorumError):
            rs.log.drain(timeout=10.0)
        return before > 0, after, cm.stats()
    finally:
        rs.shutdown()


def test_failover_abandons_salvage_but_keeps_deferred_error():
    """test_salvage_adaptive.py::test_failover_abandons_salvage_but_keeps_deferred_error"""
    got, want = on_both(failover_stash)
    assert got == want
    assert got[:2] == (True, 0)


# --------------------------------------------------------------------- #
# adaptive pipeline depth
# --------------------------------------------------------------------- #
def check_trajectory(log, ceiling):
    depths = [d for _, d in log.depth_trajectory]
    seqs = [s for s, _ in log.depth_trajectory]
    assert seqs == sorted(seqs)             # trajectory is issue-ordered
    assert all(1 <= d <= ceiling for d in depths), log.depth_trajectory


def grows_to_ceiling(core):
    rs = rset(core, wq=2, depth=4, adaptive=True, cap=1 << 20)
    try:
        log, pol = rs.log, core.FreqPolicy(2, wait=False)
        assert log.pipeline_depth == 1          # starts serial
        for _ in range(4):
            log.append(b"w" * 64)
        log.drain(timeout=10.0)
        for t in rs.transports:
            t.inject(delay_s=0.01)
        stream(log, pol, 40, size=64)
        pol.drain(log)
        assert log.durable_lsn == 44
        assert log.pipeline_depth == 4, log.depth_trajectory
        check_trajectory(log, 4)
        rs.group.drain(timeout=10.0)
        return records(core, rs.primary_dev, 1 << 20)
    finally:
        close(rs)


def test_adaptive_depth_grows_under_backpressure_to_ceiling():
    """test_salvage_adaptive.py::test_adaptive_depth_grows_under_backpressure_to_ceiling

    The growth follows the ack-rate estimator's wall-clock readings, so
    each package is held to the invariants; the records are compared."""
    got, want = on_both(grows_to_ceiling)
    assert got == want


def static_depth(core):
    rs = rset(core, wq=2, depth=4, adaptive=False, cap=1 << 20)
    try:
        log, pol = rs.log, core.FreqPolicy(2, wait=False)
        for t in rs.transports:
            t.inject(delay_s=0.005)
        stream(log, pol, 24, size=64)
        pol.drain(log)
        rs.group.drain(timeout=10.0)
        return log.depth_trajectory, records(core, rs.primary_dev, 1 << 20)
    finally:
        close(rs)


def test_adaptive_depth_static_config_never_moves():
    """test_salvage_adaptive.py::test_adaptive_depth_static_config_never_moves"""
    got, want = on_both(static_depth)
    assert got == want
    assert got[0] == [(0, 4)]


def halves_and_regrows(core):
    """Depth grows to its ceiling over clean delayed traffic, halves when
    node1 dies under four rounds it holds, and grows back to the ceiling
    over clean delayed traffic after the rejoin."""
    rs = rset(core, wq=3, depth=4, adaptive=True)
    try:
        log, pol = rs.log, core.FreqPolicy(2, wait=False)
        log.append(b"warm" * 4)
        for t in rs.transports:
            t.inject(delay_s=0.01)
        stream(log, pol, 24)
        pol.drain(log)
        assert log.pipeline_depth == 4, log.depth_trajectory
        for t in rs.transports:
            t.inject()
        hold_until_fenced(rs.transports[0])
        stream(log, pol, 8, tag=0x20)           # four rounds, all held
        kill_node1_midwire(rs, log)
        grown = len(log.depth_trajectory)
        after = log.depth_trajectory[grown - 1][1]
        assert after < 4 and log.depth_trajectory[grown - 2][1] == 4, \
            log.depth_trajectory
        rs.recover_backup("node1")
        for t in rs.transports:
            t.inject(delay_s=0.01)
        stream(log, pol, 24, tag=0x40)
        pol.drain(log)
        assert log.durable_lsn == 1 + 24 + 8 + 24
        assert log.pipeline_depth == 4, log.depth_trajectory
        check_trajectory(log, 4)
        rs.group.drain(timeout=10.0)
        return after, records(core, rs.primary_dev)
    finally:
        close(rs)


def test_adaptive_depth_halves_on_failure_and_regrows_after_clean_window():
    """test_salvage_adaptive.py::test_adaptive_depth_halves_on_failure_and_regrows_after_clean_window

    The depth right after the failure and the records are compared."""
    got, want = on_both(halves_and_regrows)
    assert got == want


def slot_timeout(core):
    """Both pipeline slots held by rounds that cannot retire, then a
    forced record waits for a slot past its timeout.

    The reference's test makes the held rounds with a 0.5 s wire, and the
    first of them can retire inside the 50 ms timeout: then the force gets
    a slot, times out waiting for its own round, and the depth does not
    halve (the controller halves only on a slot timeout).  It does so in
    both packages (ROADMAP Queue 3).  Here node1's lane holds the two
    rounds until the forced record has timed out."""
    rs = rset(core, wq=2, depth=2, adaptive=True, n_backups=1)
    try:
        log = rs.log
        log.append(b"w")
        # grow to 2 with clean overlapped traffic
        rs.transports[0].inject(delay_s=0.05)
        pol = core.FreqPolicy(1, wait=False)
        stream(log, pol, 2)
        assert log.pipeline_depth == 2, log.depth_trajectory
        log.drain(timeout=10.0)
        rs.transports[0].inject()
        timed_out = []
        hold_writes(rs.transports[0], lambda: bool(timed_out),
                    what="the forced record's slot timeout")
        stream(log, pol, 2, tag=8)              # fill both slots
        assert log.stats()["inflight_rounds"] == 2
        rid, ptr = log.reserve(16)
        ptr[:] = b"t" * 16
        log.complete(rid)
        with pytest.raises(core.LogError, match="pipeline slot") as ei:
            log.force(rid, timeout=0.05)        # no slot in time
        timed_out.append(ei.value)
        halved = log.pipeline_depth
        log.drain(timeout=10.0)
        assert log.force(rid, timeout=10.0) == rid
        rs.group.drain(timeout=10.0)
        return halved, log.depth_trajectory[2:], records(core,
                                                         rs.primary_dev)
    finally:
        close(rs)


def test_adaptive_depth_halves_on_slot_timeout():
    """test_salvage_adaptive.py::test_adaptive_depth_halves_on_slot_timeout"""
    got, want = on_both(slot_timeout)
    assert got == want
    assert got[0] == 1                      # halved by the timeout
    assert got[1] == [(5, 1)]


def round_wait_timeout(core):
    """The reference test's other outcome, made on purpose: one of the two
    held rounds retires inside the forced record's timeout.  The force then
    gets the freed slot and times out waiting for its own round, and the
    depth stays where it was, in both packages."""
    rs = rset(core, wq=2, depth=2, adaptive=True, n_backups=1)
    try:
        log = rs.log
        log.append(b"w")
        rs.transports[0].inject(delay_s=0.05)
        pol = core.FreqPolicy(1, wait=False)
        stream(log, pol, 2)
        log.drain(timeout=10.0)
        rs.transports[0].inject()
        slot_waiting, timed_out = [], []
        # the first held round goes as the force comes; the next two (the
        # second held round, the forced one) after the force's timeout
        first = hold_writes(rs.transports[0], lambda: bool(slot_waiting),
                            what="the forced record's slot wait")
        stream(log, pol, 1, tag=8)
        wait_until(lambda: first[0] == 1, "the first held round on the lane")
        hold_writes(rs.transports[0], lambda: bool(timed_out),
                    what="the forced record's round timeout")
        stream(log, pol, 1, tag=9)
        rid, ptr = log.reserve(16)
        ptr[:] = b"t" * 16
        log.complete(rid)
        slot_waiting.append(True)
        with pytest.raises(core.LogError, match="to retire") as ei:
            log.force(rid, timeout=0.5)
        timed_out.append(ei.value)
        depth = log.pipeline_depth
        log.drain(timeout=10.0)
        rs.group.drain(timeout=10.0)
        return depth, log.depth_trajectory
    finally:
        close(rs)


def test_slot_freed_inside_the_timeout_leaves_the_depth():
    """ROADMAP Queue 3's slot-timeout entry: why the reference's
    test_adaptive_depth_halves_on_slot_timeout fails on some runs."""
    got, want = on_both(round_wait_timeout)
    assert got == want
    assert got[0] == 2 and got[1] == [(0, 1), (2, 2)]


def effective_bound(core):
    rs = rset(core, wq=2, depth=4, adaptive=True, cap=1 << 20)
    try:
        log = rs.log
        log.cfg.max_threads = 1
        pol = core.FreqPolicy(4, wait=False)
        out = [pol.vulnerability_bound(log),
               pol.effective_vulnerability_bound(log)]
        for t in rs.transports:
            t.inject(delay_s=0.01)
        stream(log, pol, 32, size=32)
        pol.drain(log)
        assert log.pipeline_depth == 4, log.depth_trajectory
        out += [pol.effective_vulnerability_bound(log),
                pol.vulnerability_bound(log)]
        rs.group.drain(timeout=10.0)
        return out
    finally:
        close(rs)


def test_effective_vulnerability_bound_tracks_live_depth():
    """test_salvage_adaptive.py::test_effective_vulnerability_bound_tracks_live_depth"""
    got, want = on_both(effective_bound)
    assert got == want == [4 * (4 + 1), 4, 4, 4 * (4 + 1)]


# --------------------------------------------------------------------- #
# the async orderings' modelled costs
# --------------------------------------------------------------------- #
def ordering_cost(core, ordering):
    rs = core.build_replica_set(mode="local+remote", capacity=CAP,
                                n_backups=1, write_quorum=2, **dev_kw(core))
    try:
        dev = rs.primary_dev
        off = rs.log.ring_off
        dev.write(off, b"c" * 1024)
        fr = core.write_and_force_segs_async(dev, [(off, 1024)], rs.group,
                                             ordering)
        rep_vns = fr.round.result(timeout=10.0)
        total = fr.wait(timeout=10.0)
        rs.group.drain(timeout=10.0)
        return total, (fr.loc_vns, rep_vns, dev.cost.doorbell_ns)
    finally:
        rs.shutdown()


@pytest.mark.parametrize("ordering", tcore.ORDERINGS)
def test_async_ordering_costs_are_overlapped_not_serial(ordering):
    """test_salvage_adaptive.py::test_async_ordering_costs_are_overlapped_not_serial"""
    got, want = on_both(ordering_cost, ordering)
    assert got == want
    total, (loc, rep, bell) = got
    if ordering == tcore.REP_LF:
        expect = max(rep, loc) + bell
    elif ordering == tcore.LF_REP:
        expect = loc + rep + bell
    else:                                   # PARALLEL
        expect = max(rep, loc) + 0.1 * min(loc, rep) + bell
    assert total == pytest.approx(expect)
    assert loc > 0 and rep > 0


def test_parallel_cost_below_serial_sum_and_orderings_ranked():
    """test_salvage_adaptive.py::test_parallel_cost_below_serial_sum_and_orderings_ranked"""
    totals = {o: ordering_cost(tcore, o) for o in tcore.ORDERINGS}
    par, (loc, rep, bell) = totals[tcore.PARALLEL]
    assert par < loc + rep + 0.1 * min(loc, rep) + bell
    assert totals[tcore.REP_LF][0] <= totals[tcore.PARALLEL][0]


# --------------------------------------------------------------------- #
# property tests: controller + salvage invariants (fixed seeds)
# --------------------------------------------------------------------- #
def controller_invariants(core, seed):
    """One randomized run: depth never exceeds the ceiling, durable_lsn
    stays a gapless prefix under any grow/shrink schedule, and the final
    recovered contents match what was appended."""
    rng = np.random.default_rng(seed)
    ceiling = int(rng.integers(1, 6))
    wq = int(rng.integers(2, 4))
    rs = rset(core, wq=wq, depth=ceiling, adaptive=True)
    log, pol = rs.log, core.FreqPolicy(int(rng.integers(1, 4)), wait=False)
    written = {}
    n = int(rng.integers(6, 20))
    fail_at = int(rng.integers(2, n)) if rng.random() < 0.5 and wq == 3 \
        else None
    rs.transports[1].inject(delay_s=0.002)
    try:
        for i in range(n):
            if fail_at is not None and i == fail_at:
                rs.kill_backup_midwire("node1", settle_s=0.0)
                rs.recover_backup("node1")
            rid, ptr = log.reserve(24)
            data = bytes([(seed + i) & 0xFF]) * 24
            ptr[:] = data
            written[rid] = data
            log.complete(rid)
            pol.on_complete(log, rid)
            s = log.stats()
            assert 1 <= s["pipeline_depth"] <= ceiling
            assert s["durable_lsn"] <= s["complete_upto"]
        pol.drain(log)
        assert log.durable_lsn == n
        check_trajectory(log, ceiling)
        got = records(core, rs.primary_dev)
        assert got == written        # gapless, intact, nothing lost
        return got
    finally:
        close(rs)


@pytest.mark.parametrize("seed", range(8))
def test_controller_invariants_deterministic_sweep(seed):
    """test_salvage_adaptive.py::test_controller_invariants_deterministic_sweep"""
    got, want = on_both(controller_invariants, seed)
    assert got == want


@settings(max_examples=15, deadline=None, derandomize=True)
@given(st.integers(min_value=0, max_value=10_000))
def test_controller_invariants_property(seed):
    """test_salvage_adaptive.py::test_controller_invariants_property"""
    got, want = on_both(controller_invariants, seed)
    assert got == want


def salvage_equivalence(core, seed):
    """Salvage vs full re-issue under the same seeded fault schedule: the
    same durable watermark and records, and the salvaged run never
    re-sends more than the full re-issue counterfactual."""
    final = {}
    for salvage in (True, False):
        rng = np.random.default_rng(seed)
        rs = rset(core, salvage=salvage)
        log, pol = rs.log, core.FreqPolicy(2, wait=False)
        n = int(rng.integers(6, 16))
        fail_at = int(rng.integers(1, n))
        rs.transports[0].inject(delay_s=0.06)
        rs.transports[1].inject(delay_s=0.002)
        try:
            for i in range(n):
                if i == fail_at:
                    rs.kill_backup_midwire("node1", settle_s=0.01)
                    rs.recover_backup("node1")
                rid, ptr = log.reserve(24)
                ptr[:] = bytes([(seed + i) & 0xFF]) * 24
                log.complete(rid)
                try:
                    pol.on_complete(log, rid)
                except core.QuorumError:
                    assert not salvage          # full re-issue arm only
                    pol.on_complete(log, rid)
            try:
                pol.drain(log)
            except core.QuorumError:
                assert not salvage
                pol.drain(log)
            final[salvage] = (log.durable_lsn,
                              records(core, rs.primary_dev))
            if salvage:
                s = log.stats()
                assert s["reissue_bytes"] <= s["full_reissue_bytes"]
        finally:
            close(rs)
    assert final[True] == final[False]
    return final[True]


@pytest.mark.parametrize("seed", range(6))
def test_salvage_equivalence_deterministic_sweep(seed):
    """test_salvage_adaptive.py::test_salvage_equivalence_deterministic_sweep"""
    got, want = on_both(salvage_equivalence, seed)
    assert got == want


@settings(max_examples=10, deadline=None, derandomize=True)
@given(st.integers(min_value=0, max_value=10_000))
def test_salvage_equivalence_property(seed):
    """test_salvage_adaptive.py::test_salvage_equivalence_property"""
    got, want = on_both(salvage_equivalence, seed)
    assert got == want
