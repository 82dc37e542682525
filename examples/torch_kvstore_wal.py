"""A durable key-value store on the PyTorch port's Arcadia WAL (the
paper's RocksDB integration, §5.6) — multi-threaded through the
group-commit ingestion front end (DESIGN.md §10), including a
crash/recover round trip.

Eight producer threads call kv.put() concurrently.  Each put submits
its redo record to the IngestEngine's bounded queue and blocks until
that record's durable ack; the engine coalesces whatever is queued
into one reserve/copy/complete batch and shared pipeline force rounds.
The log's integrity hash runs on ``--device`` (the card by default;
``cpu`` runs its plain version):

    PYTHONPATH=src python examples/torch_kvstore_wal.py [--device cpu]
"""

import argparse
import threading

import numpy as np

from repro_torch.apps.kvstore import DurableKV
from repro_torch.core import (IngestConfig, Log, LogConfig, PMEMDevice,
                              device_size, make_policy)

THREADS = 8
PUTS_PER_THREAD = 50


def main(device="cuda"):
    dev = PMEMDevice(device_size(1 << 20), mode="strict")
    log = Log.create(dev, LogConfig(capacity=1 << 20, pipeline_depth=4),
                     device=device)
    kv = DurableKV(log, make_policy("freq", freq=8),
                   ingest=IngestConfig(flush_records=64,
                                       flush_interval_s=0.001))

    def producer(tid: int):
        for i in range(PUTS_PER_THREAD):
            # blocks until this record's durable watermark ack
            kv.put(f"user:{tid}:{i:04d}".encode(),
                   f"value-{tid}-{i}".encode())

    workers = [threading.Thread(target=producer, args=(t,))
               for t in range(THREADS)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    kv.flush()                             # drain the engine: all acked

    st = kv.ingest.stats()
    total = THREADS * PUTS_PER_THREAD
    print(f"{len(kv)} keys from {THREADS} threads; "
          f"durable_lsn={log.durable_lsn}")
    print(f"group commit: {st['waves']} waves for {st['acked']} records "
          f"(~{st['acked'] / max(st['waves'], 1):.1f} records/wave, "
          f"largest {st['max_wave_records']})")
    kv.close()

    # power loss: every acked put must survive
    survivor = dev.crash(np.random.default_rng(1), keep_probability=0.2)
    relog = Log.open(survivor, LogConfig(capacity=1 << 20), device=device)
    kv2 = DurableKV.recover(relog)
    ok = all(kv2.get(f"user:{t}:{i:04d}".encode()) is not None
             for t in range(THREADS) for i in range(PUTS_PER_THREAD))
    print(f"after crash: {len(kv2)} keys recovered "
          f"(all {total} acked puts present: {ok})")
    print(f"sample: user:3:0042 -> {kv2.get(b'user:3:0042')}")
    if not ok:
        raise SystemExit("an acked put was lost")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
