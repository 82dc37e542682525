"""Quickstart on the PyTorch port: the Arcadia log API in five minutes.

The log's integrity hash runs on ``--device`` (the card by default, where
it is a CUDA kernel; ``cpu`` runs its plain version):

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core import (Log, LogConfig, PMEMDevice, build_replica_set,
                              device_size)


def main(device="cuda"):
    # --- 1. a local log on (simulated) PMEM ----------------------------
    dev = PMEMDevice(device_size(1 << 20), mode="strict")
    log = Log.create(dev, LogConfig(capacity=1 << 20), device=device)

    # coarse API: append = reserve + copy + complete + force
    rid = log.append(b"hello pmem")
    print(f"appended record lsn={rid}, durable up to {log.durable_lsn}")

    # fine-grained API: assemble the record directly, overlap your own
    # compute between the stages, amortize the force (freq policy)
    for i in range(16):
        rid, ptr = log.reserve(32)
        log.copy(rid, f"record-{i:02d}".encode().ljust(32))
        log.complete(rid)                 # concurrent-safe
        log.force(rid, freq=8)            # only every 8th LSN forces
    print(f"freq-8 force: durable={log.durable_lsn}, "
          f"completed={log.completed_lsn}, "
          f"window={log.vulnerability_window()} "
          f"(bound {log.vulnerability_bound(8)})")

    # --- 2. crash + recover --------------------------------------------
    survivor = dev.crash(np.random.default_rng(0), keep_probability=0.3)
    relog = Log.open(survivor, LogConfig(capacity=1 << 20), device=device)
    recs = list(relog.iter_records())
    print(f"after power loss: {len(recs)} records recovered, "
          f"committed prefix intact (no torn data can surface)")

    # --- 3. replication ---------------------------------------------------
    rs = build_replica_set(mode="local+remote", capacity=1 << 20,
                           n_backups=2, write_quorum=2, device=device)
    for i in range(8):
        rs.log.append(f"replicated-{i}".encode())
    print(f"replicated to {len(rs.servers)} backups with W=2; "
          f"N={rs.n_durable} durable copies")
    rs.fail_backup("node1")               # partition one backup
    rs.log.append(b"still-durable")       # W=2 of N=3 still holds
    print("survived a backup partition (Table 1 ✓)")
    rs.shutdown()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
