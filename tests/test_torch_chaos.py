"""Seeded multi-fault schedules on the port's replicated log (core/health.py,
core/cluster.py, core/lifecycle.py, core/transport.py) against the JAX
package on the CPU: the counterparts of tests/test_chaos_soak.py, each
naming the JAX test it mirrors.

Each schedule composes faults drawn from a seeded generator against a live
three-copy replica set: bit rot on committed records (any copy, primary
included), a backup partition ridden out in degraded quorum, or a mid-wire
backup kill with a pipelined round in flight, then a rejoin with online
resync, more traffic and a scrub to clean.  The reference kills the backup
by the clock (a 30 ms wire, a 30 ms settle); here its lane holds the
round until the fence, and the kill waits for the survivor's ack.  Every
schedule then runs the same on every run, on both packages, and is
compared with ==: what the scrub found and repaired, the resync report,
the recovered records and every copy's image.  The soaks race threads
(ingest producers, a background scrubber, a background truncator) and
hold the port to the reference's invariants, waiting on states instead
of sleeps.
"""

import random
import threading

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import log as jlog
from repro_torch.core import log as tlog

from torch_parity import dev_kw, hold_until_fenced, lane_acked_all, \
    on_both, wait_until

C_CAP = 1 << 16
N_SCHEDULES = 64


def payload(lsn: int) -> bytes:
    return bytes([(lsn * 37 + 11) & 0xFF]) * (40 + (lsn % 4) * 8)


def copy_devs(rs):
    devs = {"node0": rs.primary_dev}
    devs.update({s.server_id: s.device for s in rs.servers})
    return devs


def is_clean(core, dev, log, lsn) -> bool:
    """The scrubber's own validation, applied to one record on one copy
    (through each package's ``_first_bad_payload``)."""
    m = tlog if core is tcore else jlog
    rec = log._recs[lsn]
    raw = dev.read(rec.off, rec.extent)
    hl, hs, hc, hf = m._REC_HDR.unpack_from(raw, 0)
    if hf & m.FLAG_CLEANED and hl == lsn and hs == rec.size:
        return True
    if hl != lsn or hs != rec.size or not hf & m.FLAG_VALID \
            or hf & m.FLAG_PAD:
        return False
    items = [(0, 0, lsn, rec.size, hc, hf)]
    if core is tcore:
        snap = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
        return m._first_bad_payload(snap, items, log.device) is None
    return m._first_bad_payload(raw, items) is None


def inject_rot(rs, rng, np_rng, n, exclude=()):
    """Corrupt up to ``n`` distinct committed records, each on one randomly
    chosen copy.  -> the (copy, lsn) pairs whose bytes really changed."""
    log = rs.log
    devs = copy_devs(rs)
    committed = [lsn for lsn, r in sorted(log._recs.items())
                 if lsn <= log.durable_lsn and not r.pad
                 and log._head_lsn <= lsn]
    rng.shuffle(committed)
    injected = []
    for lsn in committed[:n]:
        name = rng.choice([c for c in devs if c not in exclude])
        rec = log._recs[lsn]
        dev = devs[name]
        before = dev.read(rec.off, rec.extent)
        dev.corrupt(rec.off + 24, rec.size, np_rng, nbits=8)
        if dev.read(rec.off, rec.extent) != before:
            injected.append((name, lsn))
    return injected


def ring_image(core, rs):
    m = tlog if core is tcore else jlog
    return rs.primary_dev.read(0, m.ring_offset() + rs.cfg.capacity)


def chaos_schedule(core, seed):
    """tests/test_chaos_soak.py::test_chaos_schedule's schedule and
    invariants.  -> what to compare across the packages."""
    rng = random.Random(seed)
    np_rng = np.random.default_rng(seed)
    fault = rng.choice(["none", "partition", "partition",
                        "midwire", "midwire"])
    depth = rng.choice([1, 2, 4])
    wq = 3 if fault == "partition" else 2
    victim = rng.choice(["node1", "node2"])
    vt_idx = 0 if victim == "node1" else 1
    rs = core.build_replica_set(mode="local+remote", capacity=C_CAP,
                                n_backups=2, write_quorum=wq,
                                device_mode="strict", pipeline_depth=depth,
                                **dev_kw(core))
    try:
        cm = core.ClusterManager([core.Node(rs.primary_id)] +
                                 [core.Node(s.server_id, server=s)
                                  for s in rs.servers])
        cm.attach_log(rs.log)
        cm.attach_group(rs.group, allow_degraded=True, min_write_quorum=2)
        acked = {}

        def put(k=1):
            for _ in range(k):
                lsn = rs.log.append(payload(rs.log._next_lsn))
                acked[lsn] = payload(lsn)

        put(8)                                   # phase A: healthy traffic
        out = dict(fault=fault)
        if fault == "partition":                 # phase B: the fault, live
            rs.fail_backup(victim)
            cm.report_failure(victim)
            assert cm.stats()["degraded"] and rs.group.write_quorum == 2
            put(8)
        elif fault == "midwire":
            rs.group.drain(timeout=10.0)                     # no straggler of phase A
            hold_until_fenced(rs.transports[vt_idx])
            inflight = b"\x5a" * 64
            rid, _ = rs.log.reserve(len(inflight))
            rs.log.copy(rid, inflight)
            rs.log.complete(rid)
            rs.log.force(rid, wait=False)        # round in flight on the wire
            survivor = rs.transports[1 - vt_idx]
            wait_until(lambda: lane_acked_all(rs.log, survivor),
                       "the survivor's ack of the round in flight")
            rs.kill_backup_midwire(victim, settle_s=0.0)
            acked[rid] = inflight
            put(7)                               # W=2: local + survivor
        else:
            put(8)
        rs.group.drain(timeout=10.0, surface_errors=False)
        injected = inject_rot(rs, rng, np_rng, n=rng.randint(1, 3))
        out["injected"] = sorted(injected)
        if fault != "none":                      # phase C: rejoin, resync
            rs.transports[vt_idx].inject()
            rep = rs.recover_backup(victim)
            assert rep.server_id == victim
            out["resync"] = (rep.sealed_bytes, rep.repair_bytes)
            if fault == "partition":
                assert 0 < rep.repair_bytes < rep.sealed_bytes
                cm.report_recovery(victim)
                assert not cm.stats()["degraded"]
                assert rs.group.write_quorum == 3
        put(8)
        rs.log.drain(timeout=10.0)
        rs.group.drain(timeout=10.0)

        devs = copy_devs(rs)
        bad_lsns = {lsn for _, lsn in injected}
        still_bad = {(name, lsn) for lsn in bad_lsns for name in devs
                     if not is_clean(core, devs[name], rs.log, lsn)}
        pw0 = rs.primary_dev.stats.bytes_written
        sc = core.Scrubber.from_replica_set(rs)
        reports = sc.scrub_to_completion(max_passes=64)
        found = {cr for r in reports for cr in r.corrupt_records}
        st = sc.stats()
        # 1. detection and repair are exact: everything injected, no more
        assert found == still_bad
        assert st["repaired"] == len(still_bad) and st["unrepairable"] == 0
        assert reports[-1].complete and reports[-1].corrupt == 0
        # 2. repair traffic is a strict subset of the golden image
        golden = sum(r.extent for lsn, r in rs.log._recs.items()
                     if lsn <= rs.log.durable_lsn and not r.pad)
        if still_bad:
            assert 0 < st["repair_bytes"] < golden
        else:
            assert st["repair_bytes"] == 0
        # 3. the primary saw only writes the scrubber accounts for
        pw_extra = rs.primary_dev.stats.bytes_written - pw0
        assert pw_extra <= st["repair_bytes"]
        if not any(name == "node0" for name, _ in still_bad):
            assert pw_extra == 0
        # 4. every acked record survived with its payload
        got = {lsn: bytes(p) for lsn, p in rs.log.iter_records()}
        for lsn, p in acked.items():
            assert got[lsn] == p, f"acked lsn {lsn} lost or mangled"
        # 5. the three copies converged byte for byte
        ring = ring_image(core, rs)
        for srv in rs.servers:
            assert srv.device.read(0, len(ring)) == ring
        out.update(still_bad=sorted(still_bad), found=sorted(found),
                   scrub={k: st[k] for k in ("corrupt_found", "repaired",
                                             "repair_bytes", "passes",
                                             "scanned_bytes")},
                   pw_extra=pw_extra, records=got, ring=ring,
                   cluster=cm.stats())
        return out
    finally:
        rs.shutdown()


@pytest.mark.parametrize("seed", range(N_SCHEDULES))
def test_chaos_schedule(seed):
    """test_chaos_soak.py::test_chaos_schedule"""
    got, want = on_both(chaos_schedule, seed)
    assert got == want


# --------------------------------------------------------------------- #
# hot-path interaction soaks
# --------------------------------------------------------------------- #
def rset4(core=tcore, **kw):
    return core.build_replica_set(mode="local+remote", capacity=C_CAP,
                                  n_backups=2, write_quorum=2,
                                  device_mode="strict", pipeline_depth=4,
                                  **kw, **dev_kw(core))


def test_soak_scrub_under_hot_ingest():
    """test_chaos_soak.py::test_soak_scrub_under_hot_ingest

    The scrubber checks every copy up to durable_lsn, and at W = 2 of 3 a
    straggler backup may not yet hold a durable record: a pass that meets
    one flags it and rewrites it from a clean copy (both packages; ROADMAP
    Queue 3).  So the count of findings is held to the repairs, not to
    one; the planted rot must be among them."""
    rs = rset4()
    eng = rs.attach_ingest(tcore.IngestConfig(flush_records=4),
                           policy=tcore.FreqPolicy(4))
    sc = None
    try:
        for t in [eng.append(payload(i + 1)) for i in range(8)]:
            t.wait(timeout=30)
        rs.group.drain(timeout=10.0)
        np_rng = np.random.default_rng(99)
        rec = rs.log._recs[3]
        dev = rs.servers[0].device
        before = dev.read(rec.off, rec.extent)
        dev.corrupt(rec.off + 24, rec.size, np_rng, nbits=8)
        assert dev.read(rec.off, rec.extent) != before
        sc = tcore.Scrubber.from_replica_set(
            rs, cfg=tcore.ScrubConfig(interval_s=0.002))
        sc.start()
        tickets = []

        def producer(tid):
            for i in range(20):
                tickets.append(eng.append(b"%d:%d" % (tid, i) * 8,
                                          timeout=30))

        threads = [threading.Thread(target=producer, args=(t,))
                   for t in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        assert not any(th.is_alive() for th in threads)
        eng.drain(timeout=30)
        wait_until(lambda: is_clean(tcore, dev, rs.log, 3),
                   "the background scrub's repair of the planted rot")
        sc.stop()
        st = sc.stats()
        assert st["repaired"] >= 1 and st["unrepairable"] == 0
        assert st["corrupt_found"] == st["repaired"]
        for t in tickets:
            assert t.wait(timeout=30) <= rs.log.durable_lsn
        rs.group.drain(timeout=10.0)
        reports = sc.scrub_to_completion(max_passes=8)   # quiesced: clean
        assert reports[0].corrupt == 0 and reports[-1].complete
        ring = ring_image(tcore, rs)
        for srv in rs.servers:
            assert srv.device.read(0, len(ring)) == ring
    finally:
        if sc is not None:
            sc.stop()
        rs.shutdown()


def test_soak_resync_under_hot_ingest():
    """test_chaos_soak.py::test_soak_resync_under_hot_ingest

    The reference sleeps 20 ms before the resync for the producer to
    write while node1 is down, and on a slow run the resync finds nothing
    to repair; here it waits until 16 more records are durable."""
    rs = rset4()
    eng = rs.attach_ingest(tcore.IngestConfig(flush_records=4),
                           policy=tcore.FreqPolicy(4))
    stop = threading.Event()
    th = None
    try:
        for i in range(8):
            eng.append(payload(i + 1)).wait(timeout=30)
        rs.kill_backup_midwire("node1")
        tickets = []

        def producer():
            i = 0
            while not stop.is_set():
                tickets.append(eng.append(bytes([i & 0xFF]) * 48,
                                          timeout=30))
                i += 1
                stop.wait(0.001)           # pace: the ring holds ~900

        th = threading.Thread(target=producer)
        th.start()
        wait_until(lambda: rs.log.durable_lsn >= 24,
                   "traffic while node1 is down")
        rep = rs.recover_backup("node1")
        mark = rs.log.durable_lsn
        wait_until(lambda: rs.log.durable_lsn >= mark + 16,
                   "traffic after the resync")
        stop.set()
        th.join(timeout=30)
        assert not th.is_alive()
        assert rep.repair_bytes > 0
        eng.drain(timeout=30)
        rs.log.drain(timeout=10.0)
        rs.group.drain(timeout=10.0)
        for t in tickets:
            assert t.wait(timeout=30) <= rs.log.durable_lsn
        ring = ring_image(tcore, rs)
        assert rs.servers[0].device.read(0, len(ring)) == ring
    finally:
        stop.set()
        if th is not None:
            th.join(timeout=30)
        rs.shutdown()


def heartbeat_failover(core):
    rs = core.build_replica_set(mode="local+remote", capacity=C_CAP,
                                n_backups=2, write_quorum=3,
                                device_mode="strict", pipeline_depth=4,
                                **dev_kw(core))
    try:
        hm = rs.attach_health(allow_degraded=True, min_write_quorum=2,
                              heartbeat=core.HeartbeatConfig(
                                  interval_s=0.01, miss_threshold=2,
                                  backoff_base_s=0.05, jitter=0.0))
        acked = {}
        for i in range(4):
            lsn = rs.log.append(payload(i + 1))
            acked[lsn] = payload(lsn)
        rs.group.drain(timeout=10.0)
        # node2's lane holds the three rounds until node1 is declared down
        down = []
        from torch_parity import hold_writes
        hold_writes(rs.transports[1], lambda: bool(down),
                    what="node1's failover")
        rids = []
        for _ in range(3):
            p = b"\xa5" * 48
            rid, _ = rs.log.reserve(len(p))
            rs.log.copy(rid, p)
            rs.log.complete(rid)
            rs.log.force(rid, wait=False)
            rids.append(rid)
        rs.transports[0].inject(drop=True)      # node1 partitions mid-flight
        now, evs = 0.0, []
        for _ in range(6):
            evs += hm.tick(now)
            now += 0.02
        assert ("down", "node1") in evs
        down.append(True)
        degraded = rs.group.write_quorum
        rs.log.drain(timeout=10.0)              # in-flight rounds retire
        for rid in rids:
            acked[rid] = b"\xa5" * 48
            assert rid <= rs.log.durable_lsn
        rs.transports[0].inject()               # node1 heals -> resync
        for _ in range(10):
            evs += hm.tick(now)
            now += 0.1
        assert ("up", "node1") in evs
        restored = rs.group.write_quorum
        rs.log.drain(timeout=10.0)
        rs.group.drain(timeout=10.0)
        got = {lsn: bytes(p) for lsn, p in rs.log.iter_records()}
        for lsn, p in acked.items():
            assert got[lsn] == p
        ring = ring_image(core, rs)
        assert rs.servers[0].device.read(0, len(ring)) == ring
        return evs, degraded, restored, got, ring
    finally:
        rs.shutdown()


def test_soak_heartbeat_failover_with_inflight_rounds():
    """test_chaos_soak.py::test_soak_heartbeat_failover_with_inflight_rounds

    node2's lane holds the rounds (the reference delays it 30 ms) until
    the detector has failed node1 out on the virtual clock."""
    got, want = on_both(heartbeat_failover)
    assert got == want
    assert got[1:3] == (2, 3)


# --------------------------------------------------------------------- #
# trim lifecycle interaction soaks
# --------------------------------------------------------------------- #
def trim_slots_agree(core, rs):
    m = tlog if core is tcore else jlog
    want = rs.log.trim_lsn
    slots = [m._trim_decode(d.read(m.trim_slot_offset(), m.TRIM_SLOT_SIZE))
             for d in copy_devs(rs).values()]
    assert slots == [want] * len(slots), (slots, want)


def live_extents_converged(rs):
    log = rs.log
    for lsn, rec in sorted(log._recs.items()):
        if rec.pad or lsn < log._head_lsn or lsn > log.durable_lsn:
            continue
        gold = rs.primary_dev.read(rec.off, rec.extent)
        for srv in rs.servers:
            assert srv.device.read(rec.off, rec.extent) == gold, \
                f"live lsn {lsn} diverged on {srv.server_id}"


def trim_keeper(rs, stop, trimmed, keep=8):
    """Background truncator: keep the newest ``keep`` durable records,
    trimming whenever the durable watermark moves past them."""
    while not stop.is_set():
        d, h = rs.log.durable_lsn, rs.log.trim_lsn
        if d - keep > h:
            rs.trim(d - keep)
            trimmed.append(d - keep)
        else:
            stop.wait(0.001)


def test_soak_trim_racing_scrub():
    """test_chaos_soak.py::test_soak_trim_racing_scrub"""
    rs = rset4()
    eng = rs.attach_ingest(tcore.IngestConfig(flush_records=4),
                           policy=tcore.FreqPolicy(4))
    sc = tcore.Scrubber.from_replica_set(
        rs, cfg=tcore.ScrubConfig(interval_s=0.002))
    stop = threading.Event()
    trimmed = []
    trimmer = threading.Thread(target=trim_keeper, args=(rs, stop, trimmed))
    try:
        acked = {}
        for i in range(12):
            p = payload(i + 1)
            eng.append(p).wait(timeout=30)
            acked[i + 1] = p
        sc.start()
        trimmer.start()
        np_rng = np.random.default_rng(7)
        rot_lock = threading.Lock()
        tickets = []

        def producer(tid):
            for i in range(20):
                p = b"%d:%d" % (tid, i) * 8
                t = eng.append(p, timeout=30)
                tickets.append((t, p))
                if i % 7 == 3:     # rot lands on the hot tail, racing both
                    t.wait(timeout=30)
                    with rot_lock:
                        rec = rs.log._recs.get(t.lsn)
                        if rec is not None and not rec.pad:
                            rs.servers[tid % 2].device.corrupt(
                                rec.off + 24, rec.size, np_rng, nbits=8)

        threads = [threading.Thread(target=producer, args=(t,))
                   for t in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        assert not any(th.is_alive() for th in threads)
        eng.drain(timeout=30)
        wait_until(lambda: len(trimmed) >= 2, "the truncator's trims")
        stop.set()
        trimmer.join(timeout=30)
        assert not trimmer.is_alive()
        rs.log.drain(timeout=10.0)
        rs.group.drain(timeout=10.0)
        # a final injection on a record that stays live: the quiesced
        # verify must repair, not just find nothing
        lsn = rs.log.durable_lsn
        rec = rs.log._recs[lsn]
        dev = rs.servers[0].device
        before = dev.read(rec.off, rec.extent)
        dev.corrupt(rec.off + 24, rec.size, np_rng, nbits=8)
        assert dev.read(rec.off, rec.extent) != before
        sc.stop()
        reports = sc.scrub_to_completion(max_passes=64)
        st = sc.stats()
        assert reports[-1].complete and reports[-1].corrupt == 0
        assert st["unrepairable"] == 0 and st["repaired"] >= 1
        assert is_clean(tcore, dev, rs.log, lsn)
        assert rs.log.trim_lsn > 0 and rs.log.stats()["trimmed_records"] > 0
        got = {l: bytes(p) for l, p in rs.log.iter_records()}
        head = rs.log._head_lsn
        for l, p in acked.items():
            if l >= head:
                assert got[l] == p                # acked-never-lost
            else:
                assert l not in got               # trimmed, not resurrected
        for t, p in tickets:
            l = t.wait(timeout=30)
            assert l <= rs.log.durable_lsn
            if l >= head:
                assert got[l] == p
        trim_slots_agree(tcore, rs)
        live_extents_converged(rs)
    finally:
        stop.set()
        if trimmer.is_alive():
            trimmer.join(timeout=30)
        sc.stop()
        rs.shutdown()


def test_soak_trim_racing_backup_resync():
    """test_chaos_soak.py::test_soak_trim_racing_backup_resync

    The reference checks every copy's trim slot right after its last trim,
    which returns at the W-th ack: a straggler backup's slot write may
    still be on its lane, one watermark behind (its flaky runs, ROADMAP
    Queue 3).  Here the lanes are drained before the slots are read."""
    rs = rset4()
    eng = rs.attach_ingest(tcore.IngestConfig(flush_records=4),
                           policy=tcore.FreqPolicy(4))
    stop = threading.Event()
    trimmed = []
    trimmer = threading.Thread(target=trim_keeper, args=(rs, stop, trimmed))
    th = None
    try:
        for i in range(8):
            eng.append(payload(i + 1)).wait(timeout=30)
        rs.kill_backup_midwire("node1")
        # while node1 is gone: traffic and a watermark advance it never saw
        for i in range(8, 24):
            eng.append(payload(i + 1)).wait(timeout=30)
        rs.trim(rs.log.durable_lsn - 8)
        assert rs.log.trim_lsn > 0
        trimmer.start()
        tickets = []

        def producer():
            i = 0
            while not stop.is_set():
                tickets.append(eng.append(bytes([i & 0xFF]) * 48,
                                          timeout=30))
                i += 1
                stop.wait(0.001)           # pace: the ring holds ~900

        th = threading.Thread(target=producer)
        th.start()
        wait_until(lambda: len(trimmed) >= 1, "a trim while node1 is down")
        rep = rs.recover_backup("node1")        # resync races live trims
        n = len(trimmed)
        wait_until(lambda: len(trimmed) >= n + 1, "a trim after the resync")
        stop.set()
        th.join(timeout=30)
        trimmer.join(timeout=30)
        assert not th.is_alive() and not trimmer.is_alive()
        assert rep.server_id == "node1" and rep.repair_bytes > 0
        eng.drain(timeout=30)
        rs.log.drain(timeout=10.0)
        rs.group.drain(timeout=10.0)
        if rs.log.durable_lsn - 4 > rs.log.trim_lsn:
            rs.trim(rs.log.durable_lsn - 4)     # the rejoined lane takes it
        rs.group.drain(timeout=10.0)
        for t in tickets:
            assert t.wait(timeout=30) <= rs.log.durable_lsn
        trim_slots_agree(tcore, rs)
        live_extents_converged(rs)
        # a replacement built from the backups alone recovers the post-trim
        # view
        accs = [tcore.CopyAccessor.for_device(s.server_id, s.device)
                for s in rs.servers]
        img, _ = tcore.quorum_recover(accs, rs.cfg, write_quorum=2,
                                      local_name="node0-new", device="cpu")
        relog = tcore.Log.open(img, tcore.LogConfig(capacity=C_CAP),
                               device="cpu")
        assert relog._head_lsn == rs.log._head_lsn
        assert {l: bytes(p) for l, p in relog.iter_records()} == \
            {l: bytes(p) for l, p in rs.log.iter_records()}
    finally:
        stop.set()
        for t in (th, trimmer):
            if t is not None and t.is_alive():
                t.join(timeout=30)
        rs.shutdown()


def trim_racing_salvage(core):
    rs = rset4(core)
    try:
        acked = {}
        for _ in range(10):
            lsn = rs.log.append(payload(rs.log._next_lsn))
            acked[lsn] = payload(lsn)
        pre_durable = rs.log.durable_lsn
        rs.group.drain(timeout=10.0)
        hold_until_fenced(rs.transports[0])     # node1's write of the round
        inflight = b"\x5a" * 64
        rid, _ = rs.log.reserve(len(inflight))
        rs.log.copy(rid, inflight)
        rs.log.complete(rid)
        rs.log.force(rid, wait=False)           # round in flight on the wire
        wait_until(lambda: lane_acked_all(rs.log, rs.transports[1]),
                   "node2's ack of the round in flight")
        rs.kill_backup_midwire("node1", settle_s=0.0)
        acked[rid] = inflight
        rs.trim(pre_durable - 2)                # reclaim below the stash
        assert rs.log.trim_lsn == pre_durable - 2
        for _ in range(6):                      # degraded-quorum traffic
            lsn = rs.log.append(payload(rs.log._next_lsn))
            acked[lsn] = payload(lsn)
        assert rid <= rs.log.durable_lsn        # salvaged, not lost
        rs.transports[0].inject()
        rep = rs.recover_backup("node1")
        assert rep.server_id == "node1"
        rs.trim(rs.log.durable_lsn - 4)         # and trim again, healed
        rs.log.drain(timeout=10.0)
        rs.group.drain(timeout=10.0)
        got = {l: bytes(p) for l, p in rs.log.iter_records()}
        head = rs.log._head_lsn
        for l, p in acked.items():
            if l >= head:
                assert got[l] == p
            else:
                assert l not in got
        trim_slots_agree(core, rs)
        live_extents_converged(rs)
        return got, head, rs.log.trim_lsn, \
            (rep.sealed_bytes, rep.repair_bytes), ring_image(core, rs)
    finally:
        rs.shutdown()


def test_soak_trim_racing_salvage_stash():
    """test_chaos_soak.py::test_soak_trim_racing_salvage_stash"""
    got, want = on_both(trim_racing_salvage)
    assert got == want


# --------------------------------------------------------------------- #
# reference behaviours behind the JAX soaks' flaky runs (ROADMAP Queue 3)
# --------------------------------------------------------------------- #
def straggler_scrub(core):
    """W = 2 of 3: a record is durable once node1 has it; node2's lane
    still holds its copy when a scrub pass reads the three copies."""
    rs = core.build_replica_set(mode="local+remote", capacity=C_CAP,
                                n_backups=2, write_quorum=2,
                                device_mode="strict", **dev_kw(core))
    try:
        for i in range(4):
            rs.log.append(payload(i + 1))
        rs.group.drain(timeout=10.0)
        scrubbed = []
        from torch_parity import hold_writes
        hold_writes(rs.transports[1], lambda: bool(scrubbed),
                    what="the scrub pass")
        lsn = rs.log.append(payload(5))      # durable: local + node1
        sc = core.Scrubber.from_replica_set(rs)
        rep = sc.scrub_once(force=True)
        scrubbed.append(rep)
        rs.group.drain(timeout=10.0)
        return lsn, rs.log.durable_lsn, sorted(rep.corrupt_records), \
            sc.stats()["repaired"], ring_image(core, rs) == \
            rs.servers[1].device.read(0, len(ring_image(core, rs)))
    finally:
        rs.shutdown()


def test_scrub_flags_a_straggler_copy_of_a_durable_record():
    """The scrubber checks every copy up to durable_lsn; at W < N a
    straggler's copy of the newest durable record may not have landed, and
    the pass counts it as rot and rewrites it (both packages).  Why
    test_chaos_soak.py::test_soak_scrub_under_hot_ingest's exact count of
    one finding fails on loaded runs."""
    got, want = on_both(straggler_scrub)
    assert got == want == (5, 5, [("node2", 5)], 1, True)


def straggler_trim_slot(core):
    m = tlog if core is tcore else jlog
    rs = core.build_replica_set(mode="local+remote", capacity=C_CAP,
                                n_backups=2, write_quorum=2,
                                device_mode="strict", **dev_kw(core))
    try:
        for i in range(12):
            rs.log.append(payload(i + 1))
        rs.group.drain(timeout=10.0)
        read = []
        node2 = rs.servers[1]
        real = node2.handle_write_imm

        def held(dst_off, data, primary_id):     # node2 lands the slot late
            wait_until(lambda: bool(read), "the slot reading")
            return real(dst_off, data, primary_id)
        node2.handle_write_imm = held

        def slot(dev):
            return m._trim_decode(dev.read(m.trim_slot_offset(),
                                           m.TRIM_SLOT_SIZE))
        rs.trim(8)                           # returns at the W-th ack
        read.append([slot(d) for d in copy_devs(rs).values()])
        rs.group.drain(timeout=10.0)
        return read[0], [slot(d) for d in copy_devs(rs).values()]
    finally:
        rs.shutdown()


def test_trim_slot_on_a_straggler_lags_until_its_lane_drains():
    """A trim returns at the W-th ack, so a straggler's trim slot holds
    the previous watermark until its lane drains (both packages): why
    test_chaos_soak.py::test_soak_trim_racing_backup_resync, which reads
    every slot right after its last trim, fails on some runs."""
    got, want = on_both(straggler_trim_slot)
    assert got == want == ([8, 8, 0], [8, 8, 8])
