"""The port's group-commit ingestion front end (core/ingest.py, a copy of
the JAX package's) against the JAX package's, on the CPU, and the port's
three examples run on the CPU.

BENCH_fig9.json's ingest rows: 16 producers x 200 puts of 100 B values,
serially, from 16 threads, and through the engine; every shape recovers
the 3200 records with the row's digest 2978098261 in both packages.
"""

import json
import pathlib
import subprocess
import sys
import threading
import zlib
from collections import deque

import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as tcore
from repro.apps import kvstore as jkv
from repro_torch.apps import kvstore as tkv

from torch_parity import dev_kw, durable, on_both, stats

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIG9_DIGEST = 2978098261
THREADS, OPS, VAL = 16, 200, b"v" * 100


def kv_of(core):
    return tkv if core is tcore else jkv


def keys():
    return [[f"k{t:02d}-{i:04d}".encode() for i in range(OPS)]
            for t in range(THREADS)]


def sorted_digest(payloads):
    d = 0
    for p in sorted(payloads):
        d = zlib.crc32(p, d)
    return d


def ingest_row(core, shape):
    """benchmarks/fig9_kvstore.py::ingest_run on a 1 MiB ring (its 3200
    records of 124 B fill 460 KB): one replicated strict log (1 backup,
    sync acks), put by one thread (serial), 16 threads (scalar) or 16
    threads through the group-commit engine, 16 puts in flight each
    (grouped).  Returns the recovered records' digest, count and whether
    the LSNs are gapless."""
    grouped = shape == "grouped"
    rs = core.build_replica_set(mode="local+remote", capacity=1 << 20,
                                n_backups=1, device_mode="strict",
                                pipeline_depth=4 if grouped else 1,
                                **dev_kw(core))
    kv = kv_of(core).DurableKV(rs.log, core.SyncPolicy(),
                               ingest=core.IngestConfig() if grouped
                               else None)
    ks = keys()

    def producer(tid):
        if grouped:
            pend = deque()
            for k in ks[tid]:
                pend.append(kv.put_async(k, VAL))
                if len(pend) >= 16:
                    pend.popleft().wait()
            while pend:
                pend.popleft().wait()
        else:
            for k in ([k for kk in ks for k in kk] if shape == "serial"
                      else ks[tid]):
                kv.put(k, VAL)

    threads = [threading.Thread(target=producer, args=(t,))
               for t in range(1 if shape == "serial" else THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    kv.flush()
    engine = kv.ingest.stats() if grouped else None
    kv.close()
    rs.shutdown()
    relog = core.Log.open(rs.primary_dev, core.LogConfig(capacity=1 << 20),
                          **dev_kw(core))
    recs = list(relog.iter_records())
    lsns = [l for l, _ in recs]
    out = (sorted_digest(bytes(p) for _, p in recs), len(recs),
           lsns == list(range(1, len(recs) + 1)))
    if engine is not None:
        assert engine["acked"] == engine["submitted"] == 3200
        assert engine["failed"] == 0
    return out, (durable(rs.primary_dev) if shape == "serial" else None)


@pytest.mark.parametrize("shape", ["serial", "scalar", "grouped"])
def test_fig9_ingest_rows_recover_the_bench_digest(shape):
    """Every shape recovers the 3200 puts with the row's digest in both
    packages; the serial run's ring image is byte-identical."""
    row = json.loads((ROOT / "BENCH_fig9.json").read_text())["rows"][
        f"fig9/ingest/{shape}"]
    got, want = on_both(ingest_row, shape)
    assert got[0] == want[0] == (row["digest"], row["records"], True)
    assert row["digest"] == FIG9_DIGEST
    assert got[1] == want[1]




def one_producer(core):
    """One producer submits 300 records of 40 to 700 bytes through the
    engine (pipeline depth 2, freq-8 policy) and drains: the records land
    in submission order, so the ring image, the acks and the primary's
    DeviceStats write counters are the JAX package's whatever the waves."""
    dev = core.PMEMDevice(core.device_size(1 << 18), mode="strict")
    log = core.Log.create(dev, core.LogConfig(capacity=1 << 18,
                                              pipeline_depth=2),
                          **dev_kw(core))
    eng = core.IngestEngine(log, cfg=core.IngestConfig(flush_records=16),
                            policy=core.make_policy("freq", freq=8))
    tickets = [eng.append(bytes([i & 0xFF]) * (40 + (i * 97) % 660))
               for i in range(300)]
    acks = [t.wait(timeout=30) for t in tickets]
    eng.drain()
    st = eng.stats()
    eng.close()
    relog = core.Log.open(dev, core.LogConfig(capacity=1 << 18),
                          **dev_kw(core))
    return (acks, durable(dev), [l for l, _ in relog.iter_records()],
            {k: st[k] for k in ("submitted", "acked", "failed")},
            stats(dev)["bytes_written"])


def test_engine_acks_and_ring_image_match_jax():
    got, want = on_both(one_producer)
    assert got == want
    assert got[0] == list(range(1, 301)) and got[3]["acked"] == 300


def test_latency_percentiles_match_jax():
    lat = list(np.random.default_rng(4).exponential(0.002, 1000))
    assert tcore.latency_percentiles(lat) == jcore.latency_percentiles(lat)
    empty = tcore.latency_percentiles([])
    assert empty.keys() == jcore.latency_percentiles([]).keys()


@pytest.mark.parametrize("example", ["torch_quickstart", "torch_kvstore_wal",
                                     "torch_journaled_training"])
def test_examples_run_on_the_cpu(example):
    """The port's examples, run as a user would with ``--device cpu`` (the
    training example at its reduced preset)."""
    extra = ["--preset", "reduced"] if example == "torch_journaled_training" \
        else []
    # one intra-op thread: beside the suite's other workers a pool of
    # spinning torch threads made the training example 20x slower
    res = subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"{example}.py"),
         "--device", "cpu", *extra], capture_output=True, text=True,
        timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr
    want = {"torch_quickstart": "survived a backup partition",
            "torch_kvstore_wal": "all 400 acked puts present: True",
            "torch_journaled_training": "lifecycle check passed"}[example]
    assert want in res.stdout
