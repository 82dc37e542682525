"""Table 1 of the paper on the port (core/baselines, core/log.py,
core/recovery.py, core/ingest.py) against the JAX package on the CPU: the
counterparts of tests/test_resilience_matrix.py, each naming the JAX test
it mirrors.

              | device/node | partition | media error | power loss |
   PMDK       |      ✗      |     ✗     |      ✗      |     ✓      |
   FLEX       |      ✗      |     ✗     |      ✗      |     ✓      |
   QueryFresh |      ✓      |     ✓     |      ✗      |     ✓      |
   Arcadia    |      ✓      |     ✓     |      ✓      |     ✓      |

Every cell of the table is one case, run on both packages and compared
with ==, and each shows the failure mode the table gives it.  The seeded
fault-schedule matrix races lanes against the pipeline (stragglers, lane
deaths, mid-wire fences, crashes with rounds in flight), so each schedule
holds the port to the reference's invariants M1-M3 and its no-fault
control is compared with the JAX package's.  The trim crash schedules
run one thread and are compared with ==.
"""

import threading

import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import baselines as jbase
from repro_torch.core import baselines as tbase

from torch_parity import dev_kw, durable, hold_until_fenced, on_both, \
    wait_until

CAP = 1 << 16
RECORDS = [f"payload-{i}".encode() * 3 for i in range(12)]


def base_of(core):
    return tbase if core is tcore else jbase


def transport_of(core):
    return (tcore if core is tcore else jcore).transport


def rset(core, **kw):
    return core.build_replica_set(mode="local+remote", capacity=CAP,
                                  n_backups=2, write_quorum=2, **kw,
                                  **dev_kw(core))


def payloads(log):
    return [bytes(p) for _, p in log.iter_records()]


def corrupt(dev, off, n, seed=1):
    dev.corrupt(off, n, np.random.default_rng(seed))


# --------------------------------------------------------------------- #
# Table 1, cell by cell
# --------------------------------------------------------------------- #
def single_node(core, name, mode="fast"):
    """A baseline log on one device (QueryFresh with no backup)."""
    b = base_of(core)
    dev = core.PMEMDevice(CAP + 64, mode=mode)
    cls = {"pmdk": b.PMDKLog, "flex": b.FlexLog,
           "query_fresh": b.QueryFreshLog}[name]
    log = cls(dev, CAP, group_size=4) if name == "query_fresh" \
        else cls(dev, CAP)
    for r in RECORDS:
        log.append(r)
    if name == "query_fresh":
        log.flush()
    return dev, log, cls


def query_fresh_shipped(core, n_backups=1, partition=False):
    """QueryFresh shipping to backups at W = 2 (the local copy counts);
    with ``partition`` the first backup is cut off before any append."""
    tr = transport_of(core)
    dev = core.PMEMDevice(CAP + 64)
    backups = [tr.ReplicaServer(core.PMEMDevice(CAP + 64), f"qf-backup{i}")
               for i in range(n_backups)]
    transports = [tr.Transport(b, "qf-primary") for b in backups]
    group = tr.ReplicationGroup(transports, write_quorum=2,
                                local_is_durable=True)
    if partition:
        transports[0].inject(drop=True)
    log = base_of(core).QueryFreshLog(dev, CAP, repl=group, group_size=4)
    for r in RECORDS:
        log.append(r)
    log.flush()
    group.shutdown()
    return backups


def cell(core, system, failure):
    """One cell: (verdict, records the system hands back)."""
    if system == "arcadia":
        return arcadia_cell(core, failure)
    if failure == "power_loss":
        dev, _, cls = single_node(core, system, mode="strict")
        survivor = dev.crash(np.random.default_rng(0), keep_probability=0.0)
        got = payloads(cls.open(survivor, CAP))
        return ("survives" if got == RECORDS else "lost"), got
    if failure == "media_error":
        dev, log, _ = single_node(core, system)
        hdr = log.HEADER + {"pmdk": 8, "flex": 16, "query_fresh": 12}[system]
        corrupt(dev, hdr + 2, 8)             # inside record 1's payload
        got = payloads(log)
        if got == RECORDS:
            return "survives", got
        if len(got) == len(RECORDS):
            return "silent_corruption", got  # corrupted data returned as-is
        return "detected_not_repaired", got  # the tail is lost
    if system == "query_fresh":
        if failure == "device_failure":      # the shipped copy survives
            backups = query_fresh_shipped(core)
        else:                                # one of two backups cut off
            backups = query_fresh_shipped(core, n_backups=2, partition=True)[1:]
        got = payloads(base_of(core).QueryFreshLog.open(backups[0].device,
                                                        CAP))
        return ("survives" if got == RECORDS else "lost"), got
    # PMDK and FLEX keep one copy by design: a lost or cut-off device
    # leaves no copy anywhere to recover or serve from
    single_node(core, system)
    return "no_copy", []


def arcadia_cell(core, failure):
    if failure == "power_loss":
        dev = core.PMEMDevice(core.device_size(CAP), mode="strict")
        log = core.Log.create(dev, core.LogConfig(capacity=CAP),
                              **dev_kw(core))
        for r in RECORDS:
            log.append(r)
        survivor = dev.crash(np.random.default_rng(0), keep_probability=0.0)
        got = payloads(core.Log.open(survivor, core.LogConfig(capacity=CAP),
                                     **dev_kw(core)))
        return ("survives" if got == RECORDS else "lost"), got
    rs = rset(core)
    try:
        if failure == "partition":
            rs.log.append(RECORDS[0])
            rs.fail_backup("node2")          # partition one backup away
            for r in RECORDS[1:]:
                rs.log.append(r)             # W=2 still met
            ok = rs.log.durable_lsn == len(RECORDS)
            got = payloads(rs.log)
            return ("survives" if ok and got == RECORDS else "lost"), got
        for r in RECORDS:
            rs.log.append(r)
        rs.group.drain(timeout=10.0)
        if failure == "media_error":
            rec = rs.log._recs[3]
            corrupt(rs.primary_dev, rec.off + 24, rec.size)
            devs = rs.server_devices().items()
            local = rs.primary_id
        else:                                # the primary's device is lost
            devs = [(s.server_id, s.device) for s in rs.servers]
            local = "node0-new"
        accs = [core.CopyAccessor.for_device(n, d) for n, d in devs]
        img, report = core.quorum_recover(accs, rs.cfg, write_quorum=2,
                                          local_name=local, **dev_kw(core))
        assert report.chosen != rs.primary_id
        got = payloads(core.Log.open(img, core.LogConfig(capacity=CAP),
                                     **dev_kw(core)))
        return ("survives" if got == RECORDS else "lost"), got
    finally:
        rs.shutdown()


TABLE1 = {
    # (system, failure): (verdict, the JAX test of the cell, if any)
    ("pmdk", "power_loss"): ("survives", "test_pmdk_survives_power_loss"),
    ("pmdk", "media_error"): ("silent_corruption",
                              "test_pmdk_silently_surfaces_corruption"),
    ("pmdk", "device_failure"): (
        "no_copy", "test_unreplicated_logs_lose_everything_on_device_failure"),
    ("pmdk", "partition"): ("no_copy", None),
    ("flex", "power_loss"): ("survives", None),
    ("flex", "media_error"): ("detected_not_repaired",
                              "test_flex_detects_but_cannot_repair"),
    ("flex", "device_failure"): (
        "no_copy", "test_unreplicated_logs_lose_everything_on_device_failure"),
    ("flex", "partition"): ("no_copy", None),
    ("query_fresh", "power_loss"): ("survives", None),
    ("query_fresh", "media_error"): (
        "silent_corruption", "test_query_fresh_silently_surfaces_corruption"),
    ("query_fresh", "device_failure"): (
        "survives", "test_query_fresh_survives_device_failure"),
    ("query_fresh", "partition"): ("survives", None),
    ("arcadia", "power_loss"): ("survives",
                                "test_arcadia_survives_power_loss"),
    ("arcadia", "media_error"): (
        "survives", "test_arcadia_detects_and_repairs_corruption"),
    ("arcadia", "device_failure"): ("survives",
                                    "test_arcadia_survives_device_failure"),
    ("arcadia", "partition"): (
        "survives", "test_arcadia_survives_partition_within_quorum"),
}


@pytest.mark.parametrize("system,failure", list(TABLE1),
                         ids=[f"{s}-{f}" for s, f in TABLE1])
def test_table1_cell(system, failure):
    """test_resilience_matrix.py's Table 1 tests, one case a cell (the JAX
    test of each cell is named in ``TABLE1``; the four cells the JAX file
    leaves to its docstring are run here too)."""
    got, want = on_both(cell, system, failure)
    assert got == want
    assert got[0] == TABLE1[system, failure][0], got


# --------------------------------------------------------------------- #
# deterministic fault-schedule matrix (M1-M3)
# --------------------------------------------------------------------- #
M_CAP = 1 << 14
M_RECORDS = 18
M_SIZE = 32
M_FREQ = 2
M_STAT_KEYS = ("writes", "bytes_written", "flushes", "lines_flushed",
               "fences")
M_SEEDS = range(104)


def m_payload(lsn: int) -> bytes:
    return bytes([(lsn * 37 + 11) & 0xFF]) * M_SIZE


def m_run(core, schedule, drain=True):
    """Drive one schedule: (replica set, log, highest durable seen,
    quorum failures absorbed).  A fence kills the backup with the rounds
    in flight and no settle (the invariants hold whatever acks landed)."""
    rs = core.build_replica_set(mode="local+remote", capacity=M_CAP,
                                n_backups=2, write_quorum=schedule["wq"],
                                device_mode="strict",
                                pipeline_depth=schedule["depth"],
                                adaptive_depth=schedule["adaptive"],
                                **dev_kw(core))
    log = rs.log
    pol = core.FreqPolicy(M_FREQ, wait=False)
    fenced, durable_max, absorbed = None, 0, 0
    for i in range(M_RECORDS):
        for kind, arg in schedule["events"].get(i, ()):
            if kind == "straggler":
                rs.transports[arg].inject(delay_s=0.002)
            elif kind == "lane_death":        # W=2 only: quorum survives
                rs.transports[arg].inject(drop=True)
            elif kind == "fence":             # W=3: quorum failure mid-wire
                rs.kill_backup_midwire(f"node{arg + 1}", settle_s=0.0)
                fenced = arg
            elif kind == "rejoin":
                rs.recover_backup(f"node{arg + 1}")
                fenced = None
        rid = log.reserve(M_SIZE)[0]
        log.copy(rid, m_payload(rid))         # strict mode: no view()
        log.complete(rid)
        try:
            pol.on_complete(log, rid)
        except core.QuorumError:
            assert schedule["wq"] == 3, "quorum failure in a W=2 schedule"
            absorbed += 1
        durable_max = max(durable_max, log.durable_lsn)
    if fenced is not None:                    # W=3 must regain quorum
        rs.recover_backup(f"node{fenced + 1}")
    if drain:
        pol.drain(log)
    return rs, log, max(durable_max, log.durable_lsn), absorbed


def m_schedule(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    quorum_fault = bool(rng.random() < 0.5)
    wq = 3 if quorum_fault else 2
    events = {}

    def add(i, ev):
        events.setdefault(int(i), []).append(ev)

    if rng.random() < 0.6:
        add(rng.integers(0, M_RECORDS), ("straggler", int(rng.integers(2))))
    if quorum_fault:
        at = int(rng.integers(1, M_RECORDS - 2))
        victim = int(rng.integers(2))
        add(at, ("fence", victim))
        add(rng.integers(at + 1, M_RECORDS), ("rejoin", victim))
    elif rng.random() < 0.6:
        add(rng.integers(1, M_RECORDS), ("lane_death", int(rng.integers(2))))
    return dict(wq=wq, depth=int(rng.choice([2, 4])),
                adaptive=bool(rng.random() < 0.5), events=events,
                crash=("none", "after_drain", "mid")[int(rng.integers(3))])


def m_open(core, dev):
    return {lsn: bytes(p) for lsn, p in core.Log.open(
        dev, core.LogConfig(capacity=M_CAP), **dev_kw(core)).iter_records()}


def m_control(core):
    """The no-fault control for M2/M3 (the same workload, no events)."""
    rs, log, _, _ = m_run(core, dict(wq=2, depth=4, adaptive=False,
                                     events={}))
    try:
        survivor = rs.primary_dev.crash(np.random.default_rng(0))
        stats = {k: getattr(rs.primary_dev.stats, k) for k in M_STAT_KEYS}
        return m_open(core, survivor), stats
    finally:
        rs.group.drain(timeout=10.0)
        rs.shutdown()


_CONTROL = []


def control():
    if not _CONTROL:
        _CONTROL.append(on_both(m_control))
    return _CONTROL[0]


def test_fault_schedule_control_matches_jax():
    """The no-fault control of test_resilience_matrix.py's schedule matrix
    (its ``_m_control``) on both packages."""
    got, want = control()
    assert got == want
    assert sorted(got[0]) == list(range(1, M_RECORDS + 1))


def test_fault_schedules_are_the_reference_generator():
    """Each seed draws the same schedule as the JAX test's ``_m_schedule``."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).with_name("test_resilience_matrix.py")
    spec = importlib.util.spec_from_file_location("_jax_matrix", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert all(m_schedule(s) == mod._m_schedule(s) for s in M_SEEDS)


@pytest.mark.parametrize("seed", M_SEEDS)
def test_fault_schedule_matrix(seed):
    """test_resilience_matrix.py::test_fault_schedule_matrix

    M1: every record acked durable is recovered intact, as a gapless
    prefix; M2: a drained run recovers the no-fault control's records;
    M3: the faults add no write-side work on the primary's device."""
    control_contents, control_stats = control()[0]
    schedule = m_schedule(seed)
    crash_mid = schedule["crash"] == "mid"
    rs, log, durable_max, absorbed = m_run(tcore, schedule,
                                           drain=not crash_mid)
    try:
        if crash_mid:
            survivor = rs.primary_dev.crash(np.random.default_rng(seed))
            got = m_open(tcore, survivor)
            lsns = sorted(got)
            assert lsns == list(range(1, len(lsns) + 1)), \
                f"hole in recovered prefix: {lsns}"
            assert len(lsns) >= durable_max, "acked records lost"   # M1
            assert all(p == m_payload(l) for l, p in got.items())
            return
        assert log.durable_lsn == M_RECORDS
        dev = rs.primary_dev
        if schedule["crash"] == "after_drain":
            dev = dev.crash(np.random.default_rng(seed))
        assert m_open(tcore, dev) == control_contents            # M1+M2
        stats = {k: getattr(rs.primary_dev.stats, k) for k in M_STAT_KEYS}
        if absorbed == 0:
            assert stats == control_stats                        # M3
        else:
            # a force that surfaced the failure issued nothing; a later
            # leader covers its range: fewer flushes, never more work
            for k in M_STAT_KEYS:
                assert stats[k] <= control_stats[k], k
        assert log.stats()["pipeline_depth"] <= log.cfg.pipeline_depth
    finally:
        rs.group.drain(timeout=10.0, surface_errors=False)
        rs.shutdown()


# --------------------------------------------------------------------- #
# multi-producer ingestion
# --------------------------------------------------------------------- #
def ingest_log(core, cap=1 << 16):
    dev = core.PMEMDevice(core.device_size(cap), mode="strict")
    return dev, core.Log.create(dev, core.LogConfig(capacity=cap,
                                                    pipeline_depth=2),
                                **dev_kw(core))


def acked_power_loss(core):
    dev, log = ingest_log(core)
    eng = core.IngestEngine(log, core.IngestConfig())
    n_threads, per = 4, 20

    def producer(tid):
        for i in range(per):
            eng.append(f"a{tid}-{i:03d}".encode() * 3).wait(timeout=30)

    threads = [threading.Thread(target=producer, args=(t,))
               for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    acked = eng.stats()["acked"]
    survivor = dev.crash(np.random.default_rng(7), keep_probability=0.0)
    eng.close()
    relog = core.Log.open(survivor, core.LogConfig(capacity=1 << 16),
                          **dev_kw(core))
    got = {bytes(p) for _, p in relog.iter_records()}
    return acked, sorted(l for l, _ in relog.iter_records()), sorted(got)


def test_ingest_acked_records_survive_power_loss():
    """test_resilience_matrix.py::test_ingest_acked_records_survive_power_loss

    The producers interleave in any order: the acked count, the gapless
    LSNs and the set of payloads are compared."""
    got, want = on_both(acked_power_loss)
    assert got == want
    assert got[0] == 80 and got[1] == list(range(1, 81))


def unacked_lost(core):
    dev, log = ingest_log(core)
    eng = core.IngestEngine(log, core.IngestConfig(),
                            policy=core.FreqPolicy(4, wait=False))
    ts = [eng.append(m_payload(i + 1)) for i in range(10)]
    wait_until(lambda: eng.stats()["acked"] >= 8, "leaders 4 and 8")
    acked = {t.lsn for t in ts if t.done and t.error is None}
    durable_lsn = log.durable_lsn
    survivor = dev.crash(np.random.default_rng(11), keep_probability=0.0)
    eng.close()                              # (drains the ORIGINAL device)
    relog = core.Log.open(survivor, core.LogConfig(capacity=1 << 16),
                          **dev_kw(core))
    return acked, durable_lsn, {l: bytes(p) for l, p in relog.iter_records()}


def test_ingest_unacked_may_be_lost_but_acked_never():
    """test_resilience_matrix.py::test_ingest_unacked_may_be_lost_but_acked_never"""
    got, want = on_both(unacked_lost)
    assert got == want
    acked, durable_lsn, recs = got
    assert acked == set(range(1, 9)) and durable_lsn == 8
    assert recs == {l: m_payload(l) for l in acked}   # 9, 10 lost


def test_ingest_backpressure_no_deadlock_under_midwire_quorum_failure():
    """test_resilience_matrix.py::test_ingest_backpressure_no_deadlock_under_midwire_quorum_failure

    node1's lane holds every write until its death, so the producers are
    wedged against the 4-record queue with rounds in flight when it
    dies; the kill waits for that state instead of a 30 ms sleep."""
    rs = tcore.build_replica_set(mode="local+remote", capacity=1 << 16,
                                 n_backups=2, write_quorum=3,
                                 device_mode="strict", pipeline_depth=4,
                                 device="cpu")
    eng = tcore.IngestEngine(rs.log, tcore.IngestConfig(queue_records=4,
                                                        flush_records=4))
    hold_until_fenced(rs.transports[0])
    results = []

    def producer(tid):
        got = []
        for i in range(8):
            try:
                t = eng.append(b"%d-%d" % (tid, i) * 4, timeout=30)
                t.wait(timeout=30)
                got.append(("acked", t.lsn))
            except Exception as exc:
                got.append(("failed", type(exc).__name__))
        results.append(got)

    threads = [threading.Thread(target=producer, args=(t,))
               for t in range(4)]
    try:
        for th in threads:
            th.start()
        # each producer waits for its ticket before its next append: all
        # four wedged is four records submitted, none acked
        wait_until(lambda: rs.log.stats()["inflight_rounds"] > 0
                   and eng.stats()["submitted"] >= 4,
                   "rounds in flight with every producer wedged")
        assert eng.stats()["acked"] == 0
        rs.kill_backup_midwire("node1", settle_s=0.0)
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads), "producer deadlocked"
        assert len(results) == 4 and all(len(r) == 8 for r in results)
        d = rs.log.durable_lsn
        assert all(val <= d for r in results for kind, val in r
                   if kind == "acked")
        assert any(kind == "failed" for r in results for kind, _ in r)
        rs.recover_backup("node1")
        post = [eng.append(b"post" * 8) for _ in range(4)]
        # the storm's deferred errors surface coalesced: at most one drain
        # raises, and the next is clean
        try:
            eng.drain(timeout=30)
        except Exception:
            eng.drain(timeout=30)
        assert all(t.done for t in post)
        assert rs.log.durable_lsn == rs.log.next_lsn - 1
    finally:
        eng.close()
        rs.shutdown()


# --------------------------------------------------------------------- #
# crash-during-truncate schedules (T1-T4)
# --------------------------------------------------------------------- #
T_CAP = 1 << 14
T_RECORDS = 14
T_UPTO = 8
T_STAGES = ("pre_watermark", "pre_watermark_flush", "post_watermark",
            "post_superline")


class TrimCrash(Exception):
    pass


def crash_at(stage):
    def hook(s):
        if s == stage:
            raise TrimCrash(s)
    return hook


def t_log(core):
    dev = core.PMEMDevice(core.device_size(T_CAP), mode="strict")
    log = core.Log.create(dev, core.LogConfig(capacity=T_CAP),
                          **dev_kw(core))
    for i in range(1, T_RECORDS + 1):
        log.append(m_payload(i))
    return dev, log


def t_open(core, dev):
    return core.Log.open(dev, core.LogConfig(capacity=T_CAP), **dev_kw(core))


def t_view(relog, upto=T_UPTO, n=T_RECORDS):
    """T1-T3: the adopted head is the old one or trim + 1, and the records
    from it are a gapless, payload-exact suffix.  -> the head."""
    got = {lsn: bytes(p) for lsn, p in relog.iter_records()}
    head = min(got) if got else n + 1
    assert head in (1, upto + 1), f"torn trim state: head={head}"
    assert sorted(got) == list(range(head, n + 1))
    assert all(p == m_payload(l) for l, p in got.items())
    return head


def trim_crash_local(core, stage, keep):
    dev, log = t_log(core)
    with pytest.raises(TrimCrash):
        log.trim(T_UPTO, _crash_hook=crash_at(stage))
    seed = {s: i for i, s in enumerate(T_STAGES)}[stage] * 2 + int(keep > 0)
    survivor = dev.crash(np.random.default_rng(seed), keep_probability=keep)
    relog = t_open(core, survivor)
    return t_view(relog), relog.read_trim_watermark(), durable(survivor)


@pytest.mark.parametrize("stage", T_STAGES)
@pytest.mark.parametrize("keep", [0.0, 0.5])
def test_trim_crash_schedule_local(stage, keep):
    """test_resilience_matrix.py::test_trim_crash_schedule_local

    (The JAX test seeds its crash from Python's salted ``hash``; here the
    seed is fixed per case.)"""
    got, want = on_both(trim_crash_local, stage, keep)
    assert got == want
    head = got[0]
    if stage in ("post_watermark", "post_superline"):
        assert head == T_UPTO + 1            # the slot was flushed
    if stage == "pre_watermark" or (stage == "pre_watermark_flush"
                                    and keep == 0.0):
        assert head == 1                     # the trim never became durable


def trim_crash_replicated(core, stage):
    rs = core.build_replica_set(mode="local+remote", capacity=T_CAP,
                                n_backups=2, write_quorum=3,
                                device_mode="strict", **dev_kw(core))
    try:
        for i in range(1, T_RECORDS + 1):
            rs.log.append(m_payload(i))
        with pytest.raises(TrimCrash):
            rs.log.trim(T_UPTO, _crash_hook=crash_at(stage))
        accs = [core.CopyAccessor.for_device(s.server_id, s.device)
                for s in rs.servers]
        img, _ = core.quorum_recover(accs, rs.cfg, write_quorum=2,
                                     local_name="node0-new", **dev_kw(core))
        return t_view(t_open(core, img)), durable(img)
    finally:
        rs.group.drain(timeout=10.0, surface_errors=False)
        rs.shutdown()


@pytest.mark.parametrize("stage", ["pre_watermark_flush", "post_watermark"])
def test_trim_crash_schedule_replicated(stage):
    """test_resilience_matrix.py::test_trim_crash_schedule_replicated"""
    got, want = on_both(trim_crash_replicated, stage)
    assert got == want
    assert got[0] == (T_UPTO + 1 if stage == "post_watermark" else 1)


def rotted_watermark(core):
    m = (tcore if core is tcore else jcore).log
    dev, log = t_log(core)
    log.trim(T_UPTO)
    dev.write(m.trim_slot_offset(), b"\x13\x37\xc0\xde\xba\xad\xf0\x0d")
    dev.persist(m.trim_slot_offset(), m.TRIM_SLOT_SIZE)
    survivor = dev.crash(np.random.default_rng(41), keep_probability=0.0)
    relog = t_open(core, survivor)
    return relog.read_trim_watermark(), sorted(dict(relog.iter_records()))


def test_trim_crash_schedule_rotted_watermark():
    """test_resilience_matrix.py::test_trim_crash_schedule_rotted_watermark"""
    got, want = on_both(rotted_watermark)
    assert got == want
    assert got == (None, list(range(T_UPTO + 1, T_RECORDS + 1)))


def forged_watermark(core):
    m = (tcore if core is tcore else jcore).log
    dev, log = t_log(core)
    dev.write(m.trim_slot_offset(), m._trim_encode(T_RECORDS + 500))
    dev.persist(m.trim_slot_offset(), m.TRIM_SLOT_SIZE)
    survivor = dev.crash(np.random.default_rng(43), keep_probability=0.0)
    return sorted(dict(t_open(core, survivor).iter_records()))


def test_trim_crash_schedule_forged_watermark_beyond_chain():
    """test_resilience_matrix.py::test_trim_crash_schedule_forged_watermark_beyond_chain"""
    got, want = on_both(forged_watermark)
    assert got == want == list(range(1, T_RECORDS + 1))


def double_crash(core):
    dev, log = t_log(core)
    with pytest.raises(TrimCrash):
        log.trim(T_UPTO, _crash_hook=crash_at("pre_watermark_flush"))
    surv1 = dev.crash(np.random.default_rng(5), keep_probability=0.5)
    re1 = t_open(core, surv1)
    head1 = t_view(re1)
    upto2 = T_RECORDS - 2
    with pytest.raises(TrimCrash):
        re1.trim(upto2, _crash_hook=crash_at("post_watermark"))
    surv2 = surv1.crash(np.random.default_rng(6), keep_probability=0.0)
    got = {lsn: bytes(p) for lsn, p in t_open(core, surv2).iter_records()}
    return head1, got, durable(surv2)


def test_trim_crash_schedule_double_crash_reopen():
    """test_resilience_matrix.py::test_trim_crash_schedule_double_crash_reopen"""
    got, want = on_both(double_crash)
    assert got == want
    assert got[1] == {l: m_payload(l) for l in range(T_RECORDS - 1,
                                                     T_RECORDS + 1)}


def beyond_durable(core):
    dev, log = t_log(core)
    with pytest.raises(core.TrimError):
        log.trim(log.durable_lsn + 1)
    return log.read_trim_watermark()


def test_trim_beyond_durable_always_refused():
    """test_resilience_matrix.py::test_trim_beyond_durable_always_refused"""
    assert on_both(beyond_durable) == (0, 0)  # slot untouched by refusal
