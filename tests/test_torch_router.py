"""The port's shard router (core/router.py), KV store (apps/kvstore.py)
and baseline logs (core/baselines) against the JAX package's, on the CPU.

BENCH_fig9.json's recovered-payload digest 2978098261 is held on the
1/2/4/8-shard rows of both packages (test_torch_ingest.py holds the
serial, scalar and grouped rows).  Its
8-shard cut digest (3033390749) is that of a cut taken 50 ms into a run of
16 racing producers, so no rerun reproduces it; here the cut is taken at a
fixed point of a fixed feed, and its live view, its recovered view and the
JAX package's are held equal instead.
"""

import threading
import zlib
from collections import deque

import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as tcore
from repro.apps import kvstore as jkv
from repro.core import baselines as jbase
from repro_torch.apps import kvstore as tkv
from repro_torch.core import baselines as tbase

from torch_parity import durable, stats

FIG9_DIGEST = 2978098261
THREADS, OPS, VAL = 16, 200, b"v" * 100


def dev_kw(core):
    return {"device": "cpu"} if core is tcore else {}


def kv_of(core):
    return tkv if core is tcore else jkv


def on_both(scenario, *args):
    """Run ``scenario(core, *args)`` on both packages: (port, jax)."""
    return scenario(tcore, *args), scenario(jcore, *args)


def keys():
    return [[f"k{t:02d}-{i:04d}".encode() for i in range(OPS)]
            for t in range(THREADS)]


def sorted_digest(payloads):
    d = 0
    for p in sorted(payloads):
        d = zlib.crc32(p, d)
    return d


# --------------------------------------------------------------------- #
# BENCH_fig9.json: 16 producers x 200 puts, one log or hash-routed shards
# --------------------------------------------------------------------- #
def shard_row(core, n_shards):
    """benchmarks/fig9_kvstore.py::shard_run: 16 producers hash-route
    their puts over ``n_shards`` replicated strict shards (1 backup, W =
    2, depth 4, group-commit engines), 32 in flight each; then a snapshot
    cut, the router's parallel and serial recovery, and the digests."""
    router = core.LogRouter(**dev_kw(core))
    for i in range(n_shards):
        router.add_shard(core.ShardSpec(
            shard_id=f"s{i}", mode="local+remote", capacity=1 << 20,
            n_backups=1, device_mode="strict", pipeline_depth=4,
            ingest=core.IngestConfig()))
    encode = kv_of(core).encode_put
    ks = keys()

    def producer(tid):
        pend = deque()
        for k in ks[tid]:
            pend.append(router.submit(encode(k, VAL), key=k)[1])
            if len(pend) >= 32:
                pend.popleft().wait()
        while pend:
            pend.popleft().wait()

    threads = [threading.Thread(target=producer, args=(t,))
               for t in range(THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    router.drain()
    per_shard = {}
    payloads = []
    for sid in router.shard_ids:
        recs = list(router.shard(sid).log.iter_records())
        per_shard[sid] = len(recs)
        payloads += [bytes(p) for _, p in recs]
    cut = router.snapshot_cut()
    live = router.cut_digest(cut)
    router.shutdown()
    par = router.recover(parallel=True)
    ser = router.recover(parallel=False)
    rec_cut = sorted_digest(
        bytes(p) for sid, upto in cut.lsns.items()
        for lsn, p in par.logs[sid].iter_records() if lsn <= upto)
    return dict(digest=sorted_digest(payloads), records=len(payloads),
                per_shard=per_shard, cut_live=live, cut_recovered=rec_cut,
                parallel_eq_serial=par.digests == ser.digests,
                recovered=par.records)


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_fig9_shard_rows_recover_the_bench_digest(n_shards):
    """The key → shard map is CRC32 mod N in both packages, so each shard
    holds the same records; the digest over all shards is the row's."""
    got, want = on_both(shard_row, n_shards)
    assert got == want
    assert (got["digest"], got["records"], got["recovered"]) == \
        (FIG9_DIGEST, 3200, 3200)
    assert got["parallel_eq_serial"]
    assert got["cut_live"] == got["cut_recovered"] == FIG9_DIGEST


def fixed_cut(core):
    """8 shards fed serially: 400 puts, a snapshot cut, 400 more.  The
    cut's watermarks and its digest, live and from the recovered images
    (parallel and serial recovery), and the per-shard record streams."""
    router = core.LogRouter(**dev_kw(core))
    for i in range(8):
        router.add_shard(core.ShardSpec(
            shard_id=f"s{i}", mode="local+remote", capacity=1 << 20,
            n_backups=1, device_mode="strict", pipeline_depth=4))
    encode = kv_of(core).encode_put
    ks = [k for kk in keys() for k in kk][:800]
    for k in ks[:400]:
        router.append(encode(k, VAL), key=k)
    cut = router.snapshot_cut()
    router.wait_cut_durable(cut)
    live = router.cut_digest(cut)
    for k in ks[400:]:
        router.append(encode(k, VAL), key=k)
    router.shutdown()
    par = router.recover(parallel=True)
    ser = router.recover(parallel=False)
    rec_cut = sorted_digest(
        bytes(p) for sid, upto in cut.lsns.items()
        for lsn, p in par.logs[sid].iter_records() if lsn <= upto)
    return (dict(cut.lsns), dict(cut.durable), live, rec_cut, par.digests,
            ser.digests, par.aggregate()["last_lsns"],
            router.stats()["totals"])


def test_snapshot_cut_and_shard_recovery_match_jax():
    got, want = on_both(fixed_cut)
    assert got == want
    lsns, _, live, rec_cut, par, ser = got[:6]
    assert sum(lsns.values()) == 400 and live == rec_cut and par == ser


# --------------------------------------------------------------------- #
# placement, routing, health per shard
# --------------------------------------------------------------------- #
def placement(core):
    pl = core.ShardPlacement(nodes=("a", "b", "c", "d", "e"), stride=2)
    out = [[pl.assign(i, 2) for i in range(6)]]
    router = core.LogRouter(pl, **dev_kw(core))
    try:
        for i in range(3):
            router.add_shard(core.ShardSpec(shard_id=f"t{i}",
                                            mode="local+remote",
                                            capacity=1 << 14, n_backups=2))
        out.append([(sid, router.shard(sid).rs.primary_id,
                     [s.server_id for s in router.shard(sid).rs.servers])
                    for sid in router.shard_ids])
        out.append([router.shard_for(f"key{i}".encode()).shard_id
                    for i in range(50)])
        out.append([router.append(f"p{i}".encode(), key=f"key{i}".encode())
                    for i in range(30)])
        hms = router.attach_health(allow_degraded=True, min_write_quorum=2)
        router.fail_backup("t1", "d/t1")
        evs = []
        for step in range(6):
            evs += router.tick_health(step * 0.05)
        out += [sorted(hms), evs,
                {sid: hms[sid].cluster.stats() for sid in hms}]
        with pytest.raises(core.RouterError):
            router.add_shard(core.ShardSpec(shard_id="t0"))
        with pytest.raises(core.UnknownShardError):
            router.shard("zz")
    finally:
        router.shutdown()
    return out


def test_placement_routing_and_shard_health_match_jax():
    got, want = on_both(placement)
    assert got == want
    assert got[0][:2] == [("a", ["b", "c"]), ("c", ["d", "e"])]
    assert ("t1", "down", "d/t1") in got[-2]


# --------------------------------------------------------------------- #
# the KV stores after a crash
# --------------------------------------------------------------------- #
def durable_kv_crash(core, ingest):
    """Puts through DurableKV (scalar freq-4, batched, or the group-commit
    engine from four threads) on a strict device, a power loss that keeps
    a seeded third of the dirty units, and the table replayed from the
    surviving log."""
    dev = core.PMEMDevice(core.device_size(1 << 16), mode="strict")
    log = core.Log.create(dev, core.LogConfig(capacity=1 << 16,
                                              pipeline_depth=2),
                          **dev_kw(core))
    kv = kv_of(core).DurableKV(log, core.make_policy("freq", freq=4),
                               ingest=core.IngestConfig() if ingest
                               else None)
    items = [(f"key{i % 37}".encode(), f"val-{i}".encode() * (1 + i % 5))
             for i in range(120)]
    if ingest:
        def put(part):
            for k, v in part:
                kv.put(k, v)
        ths = [threading.Thread(target=put, args=(items[t::4],))
               for t in range(4)]
        for th in ths:
            th.start()
        for th in ths:
            th.join()
    else:
        for k, v in items[:60]:
            kv.put(k, v)
        kv.put_many(items[60:100])
        for k, v in items[100:]:
            kv.put(k, v)
    kv.flush()
    acked = {k: kv.get(k) for k, _ in items}
    kv.close()
    survivor = dev.crash(np.random.default_rng(3), keep_probability=0.3)
    relog = core.Log.open(survivor, core.LogConfig(capacity=1 << 16),
                          **dev_kw(core))
    kv2 = kv_of(core).DurableKV.recover(relog)
    table = dict(kv2._table)
    assert table == acked                   # every acked put survives
    return table, None if ingest else (durable(survivor), stats(survivor))


@pytest.mark.parametrize("ingest", [False, True], ids=["scalar", "ingest"])
def test_durable_kv_recovers_the_same_table_after_a_crash(ingest):
    """With one writer the ring images and DeviceStats are equal too; the
    four-thread engine's LSN order follows the interleaving, so there the
    tables (last writer per key is fixed: each key's puts come from one
    thread) are compared."""
    got, want = on_both(durable_kv_crash, ingest)
    assert got == want


def tenants(core):
    """Two tenants on disjoint shard groups (W = 2 of 3, and local fast),
    puts, a snapshot view, checkpoint + trim, more puts; then the primary
    of one shard is lost and recovery rebuilds the tables from the
    snapshot overlaid with the surviving suffix."""
    mkv = kv_of(core).MultiTenantKV(**dev_kw(core))
    mkv.add_tenant("alpha", n_shards=2, mode="local+remote", n_backups=2,
                   write_quorum=2, capacity=1 << 16)
    mkv.add_tenant("beta", n_shards=1, capacity=1 << 16)
    acked = {b"alpha": {}, b"beta": {}}
    for i in range(80):
        t = b"alpha" if i % 3 else b"beta"
        k, v = f"k{i % 23}".encode(), f"v{i}".encode()
        mkv.put(t, k, v)
        acked[t][k] = v
    cut, view = mkv.snapshot_view()
    _, snap, _ = mkv.checkpoint_and_trim()
    for i in range(80, 120):
        t = b"alpha" if i % 3 else b"beta"
        k, v = f"k{i % 23}".encode(), f"v{i}".encode()
        mkv.put(t, k, v)
        acked[t][k] = v
    with pytest.raises(PermissionError):
        mkv.fail_backup("beta", "alpha/s0", "node1")
    st = {t: {k: v for k, v in mkv.tenant_stats(t).items()
              if k != "shards"} for t in ("alpha", "beta")}
    mkv.close()
    devices = {sid: {n: d for n, d in
                     mkv.router.shard(sid).rs.server_devices().items()
                     if not n.startswith("node0/alpha/s0")}
               for sid in mkv.router.shard_ids}
    rec = mkv.router.recover(devices=devices)
    tables = mkv.recover_tables(rec.logs, snap)
    assert tables == acked
    return (dict(cut.lsns), view, snap, st, tables,
            {sid: sr.records for sid, sr in rec.shards.items()})


def test_multi_tenant_kv_tables_match_jax_after_a_lost_primary():
    got, want = on_both(tenants)
    assert got == want


@pytest.mark.parametrize("kind", ["pmdk", "flex", "query_fresh"])
def test_baseline_kv_recovers_the_same_table_and_image(kind):
    """BaselineKV over each comparison log: puts (scalar and batched), a
    power loss, the log reopened and the table replayed; the ring image,
    DeviceStats and the modelled vns of each append are equal."""
    def run(core):
        base = tbase if core is tcore else jbase
        dev = core.PMEMDevice(1 << 16, mode="strict")
        if kind == "pmdk":
            blog = base.PMDKLog(dev, (1 << 16) - 64)
        elif kind == "flex":
            blog = base.FlexLog(dev, (1 << 16) - 64)
        else:
            blog = base.QueryFreshLog(dev, (1 << 16) - 64, group_size=8)
        kv = kv_of(core).BaselineKV(blog)
        items = [(f"key{i % 11}".encode(), f"val-{i}".encode())
                 for i in range(40)]
        lsns = [kv.put(k, v) for k, v in items[:25]]
        lsns += kv.put_many(items[25:])
        survivor = dev.crash(np.random.default_rng(9), keep_probability=0.5)
        reopened = type(blog).open(survivor, (1 << 16) - 64,
                                   **({"group_size": 8}
                                      if kind == "query_fresh" else {}))
        kv2 = kv_of(core).BaselineKV.recover(reopened)
        return lsns, dict(kv2._table), durable(survivor), stats(survivor)
    got, want = on_both(run)
    assert got == want
