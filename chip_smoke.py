#!/usr/bin/env python3
"""Run the PyTorch port of the Arcadia log on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Builds the CUDA kernel of the lane-polynomial integrity hash from
``src/repro_torch/csrc`` and then, on the card:

  kernel        the kernel against its plain PyTorch version, bit-exact, at
                every listed shape, with its median time, the plain
                version's time and the HBM bound;
  main path     a replicated log (local primary + 2 backups, W = 2 of 3)
                with a 1 GiB ring of 1 KiB records hashed by the kernel
                (phash threshold 256 B), filled with batched appends until
                the ring is full, reopened and replayed, then rebuilt by
                quorum recovery from the two backups with the primary lost;
  default cfg   build_replica_set with the default 1 MiB threshold and 64
                records of 1 MiB, reopened and verified;
  strict crash  the 16 MiB ring of 1 KiB records on a strict device,
                crashed with keep probability 0.3 and reopened: every
                durable-acked record must come back byte-exact.

Every failure exits non-zero.  Without a CUDA card, or without the rest
of the repository beside it, the script fails before printing a result.
The last line of standard output is the JSON object
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import struct
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM CUDA-core rate, the closest
                               # published peak to the kernel's 32-bit
                               # integer multiply-adds (2 ops each)
RING_BYTES = 1 << 30           # Kafka's default log.segment.bytes
RECORD_BYTES = 1024
FIG7_RING_BYTES = 16 << 20
PHASH_THRESHOLD = 256
WAVE = 64


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median device time of ``fn`` in ms over ``reps`` calls, with the
    L2 cache flushed before each call (CUDA events)."""
    fn()                                              # warm-up
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(rows: int, lanes: int) -> tuple[float, str]:
    """Least time the card could take: each lane read once, each int64
    result written once, one multiply-add per lane."""
    t_bytes = (rows * lanes * 4 + rows * 8) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * rows * lanes / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(gen: torch.Generator, main_rows: int) -> dict:
    from repro_torch.kernels.checksum import ops, ref

    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rand = lambda shape: torch.randint(-2 ** 31, 2 ** 31, shape, device=dev,  # noqa: E731
                                       dtype=torch.int32, generator=gen)
    cases = []
    for lanes in (1, 7, 259, 4096, 5000, 32768, 32769):
        mat = rand((5, lanes))
        mat[2, lanes // 2:] = 0                      # a zero-padded row
        cases.append((f"batch(5,{lanes})", mat))
    cases.append(("batch(64,259) complete wave", rand((WAVE, 259))))
    cases.append(("batch(16008,259) fig7 ring", rand((16008, 259))))
    cases.append((f"batch({main_rows},259) 1GiB ring", rand((main_rows, 259))))
    cases.append(("batch(64,262147) 1MiB records", rand((64, 262147))))
    cases.append(("batch(4,32769) all-ones",
                  torch.full((4, 32769), -1, dtype=torch.int32, device=dev)))
    results = {}
    for name, mat in cases:
        got = ops.tensor_checksum_batch(mat)
        want = ref.checksum_lanes_2d(mat)
        err = int((got - want).abs().max())
        if err:
            raise AssertionError(f"{name}: kernel differs from plain version")
        rows, lanes = mat.shape
        big = rows * lanes > (1 << 24)
        ms = timed_ms(lambda: ops.tensor_checksum_batch(mat), 20, flush)
        plain = timed_ms(lambda: ref.checksum_lanes_2d(mat), 5 if big else 20,
                         flush)
        b, by = bound_ms(rows, lanes)
        results[name] = dict(shape=[rows, lanes], max_abs_err=err, ms=ms,
                             plain_ms=plain, bound_ms=b, bound_by=by)
        log(f"kernel {name}: exact, {ms:.6f} ms, plain {plain:.6f} ms, "
            f"bound {b:.6f} ms ({by})")
        del mat, got, want
    singles = [("tensor(1GiB uint8)",
                torch.randint(0, 256, (1 << 30,), dtype=torch.uint8,
                              device=dev, generator=gen)),
               ("tensor(bf16 8192x8192)",
                torch.randn((8192, 8192), device=dev, generator=gen
                            ).to(torch.bfloat16))]
    for name, x in singles:
        got = ops.tensor_checksum(x)
        want = ref.tensor_checksum(x)
        err = int((got - want).abs())
        if err:
            raise AssertionError(f"{name}: kernel differs from plain version")
        lanes = (x.numel() * x.element_size() + 3) // 4
        ms = timed_ms(lambda: ops.tensor_checksum(x), 20, flush)
        plain = timed_ms(lambda: ref.tensor_checksum(x), 5, flush)
        b, by = bound_ms(1, lanes)
        results[name] = dict(shape=list(x.shape), max_abs_err=err, ms=ms,
                             plain_ms=plain, bound_ms=b, bound_by=by)
        log(f"kernel {name}: exact, {ms:.6f} ms, plain {plain:.6f} ms, "
            f"bound {b:.6f} ms ({by})")
        del x
    torch.cuda.empty_cache()
    return results


def payload(i: int, base: bytes) -> bytes:
    """1 KiB record i: its index (kept above any chain LSN, so payload words
    never pose as record headers) and a window of seeded random bytes."""
    off = (i * 4099) % (len(base) - RECORD_BYTES)
    return struct.pack("<Q", (i << 32) | 0xA5A5A5A5) + \
        base[off:off + RECORD_BYTES - 8]


def replay(log_obj) -> tuple[int, int]:
    """(records, CRC32 digest of the payloads in LSN order)."""
    n, digest = 0, 0
    for _, p in log_obj.iter_records():
        n += 1
        digest = zlib.crc32(p, digest)
    return n, digest


def main_path_phase(base: bytes) -> dict:
    from repro_torch.core import (CopyAccessor, CostModel, Log, LogConfig,
                                  LogFullError, PMEMDevice, ReplicaServer,
                                  ReplicationGroup, Transport, device_size,
                                  quorum_recover)
    from repro_torch.kernels.checksum import checksum

    size = device_size(RING_BYTES)
    cost = CostModel()
    primary = PMEMDevice(size, mode="fast", cost=cost, name="node0/pmem")
    servers = [ReplicaServer(PMEMDevice(size, mode="fast", cost=cost,
                                        name=f"{b}/pmem"), server_id=b)
               for b in ("node1", "node2")]
    transports = [Transport(s, primary_id="node0", cost=cost)
                  for s in servers]
    group = ReplicationGroup(transports, 2, local_is_durable=True)
    cfg = LogConfig(capacity=RING_BYTES, write_quorum=2,
                    phash_threshold=PHASH_THRESHOLD)
    out = {}
    try:
        wal = Log.create(primary, cfg, repl=group)
        checksum.LAUNCHES = 0
        t0 = time.perf_counter()
        acked, digest, i, n = 0, 0, 0, WAVE
        while True:
            wave = [payload(i + k, base) for k in range(n)]
            try:
                lsns = wal.append_batch(wave)
            except LogFullError:
                if n == 1:
                    break
                n = 1                 # top the ring up one record at a time
                continue
            if wal.durable_lsn < lsns[-1]:
                raise AssertionError("append_batch returned before durable")
            for p in wave:
                digest = zlib.crc32(p, digest)
            acked += len(wave)
            i += len(wave)
        group.drain()
        out["fill_s"] = time.perf_counter() - t0
        out["fill_launches"] = checksum.LAUNCHES
        out["acked"] = acked
        log(f"main fill: {acked} records of {RECORD_BYTES} B acked (W=2 of 3) "
            f"in {out['fill_s']:.3f} s, {out['fill_launches']} kernel launches")
        if out["fill_launches"] < acked // WAVE:
            raise AssertionError("complete_batch did not go through the kernel")

        checksum.LAUNCHES = 0
        t0 = time.perf_counter()
        reopened = Log.open(primary, LogConfig(capacity=RING_BYTES))
        got = replay(reopened)
        out["open_iter_s"] = time.perf_counter() - t0
        out["recovery_launches"] = checksum.LAUNCHES
        log(f"main reopen+replay: {got[0]} records in {out['open_iter_s']:.3f} s, "
            f"{out['recovery_launches']} kernel launches")
        if got != (acked, digest):
            raise AssertionError(f"replay {got} != acked {(acked, digest)}")
        if out["recovery_launches"] < 2:
            raise AssertionError("recovery scan did not go through the kernel")
        del reopened

        checksum.LAUNCHES = 0
        t0 = time.perf_counter()
        accs = [CopyAccessor.for_device(s.server_id, s.device) for s in servers]
        img, report = quorum_recover(accs, cfg, write_quorum=2,
                                     local_name="node0-rebuilt")
        rebuilt = replay(Log.open(img, LogConfig(capacity=RING_BYTES)))
        out["rebuild_s"] = time.perf_counter() - t0
        out["rebuild_launches"] = checksum.LAUNCHES
        log(f"main primary-lost rebuild: {rebuilt[0]} records from "
            f"{report.chosen}, epoch {report.old_epoch}->{report.new_epoch}, "
            f"repair bytes {report.repair_bytes}, in {out['rebuild_s']:.3f} s, "
            f"{out['rebuild_launches']} kernel launches")
        if rebuilt != (acked, digest):
            raise AssertionError(f"rebuild {rebuilt} != acked {(acked, digest)}")
        if out["rebuild_launches"] < 4:
            raise AssertionError("quorum recovery did not go through the kernel")
    finally:
        group.shutdown()
    return out


def default_config_phase(base: bytes) -> dict:
    from repro_torch.core import Log, LogConfig, build_replica_set
    from repro_torch.kernels.checksum import checksum

    cap = 72 << 20                        # 64 records of 1 MiB + headers
    rs = build_replica_set(mode="local+remote", capacity=cap, n_backups=2,
                           write_quorum=2)
    try:
        rec = base[: 1 << 20]
        payloads = [struct.pack("<Q", (i << 32) | 0xA5A5A5A5) + rec[8:]
                    for i in range(64)]
        checksum.LAUNCHES = 0
        for w in range(0, 64, 8):
            rs.log.append_batch(payloads[w:w + 8])
        rs.group.drain()
        fill = checksum.LAUNCHES
        checksum.LAUNCHES = 0
        relog = Log.open(rs.primary_dev, LogConfig(capacity=cap))
        got = [p for _, p in relog.iter_records()]
        rec_launches = checksum.LAUNCHES
    finally:
        rs.shutdown()
    log(f"default config: 64 x 1 MiB records (threshold "
        f"{rs.cfg.phash_threshold}), {fill} launches on append, "
        f"{rec_launches} on reopen+replay")
    if got != payloads or fill < 8 or rec_launches < 2:
        raise AssertionError("default-config phase failed")
    return dict(fill_launches=fill, recovery_launches=rec_launches)


def strict_crash_phase(base: bytes) -> dict:
    from repro_torch.core import (Log, LogConfig, LogFullError, PMEMDevice,
                                  device_size)
    from repro_torch.kernels.checksum import checksum

    dev = PMEMDevice(device_size(FIG7_RING_BYTES), mode="strict")
    cfg = LogConfig(capacity=FIG7_RING_BYTES, phash_threshold=PHASH_THRESHOLD)
    wal = Log.create(dev, cfg)
    written, i = {}, 0
    checksum.LAUNCHES = 0
    full = False
    while not full:
        wave = [payload(i + k, base) for k in range(WAVE)]
        force = (i // WAVE) % 5 != 4          # every fifth wave stays unforced
        try:
            if force:
                lsns = wal.append_batch(wave)
            else:
                batch = wal.reserve_batch([len(p) for p in wave])
                wal.copy_batch(batch, wave)
                wal.complete_batch(batch)
                lsns = batch.lsns
        except LogFullError:
            full = True
            continue
        written.update(zip(lsns, wave))
        i += WAVE
    durable = wal.durable_lsn
    fill = checksum.LAUNCHES
    survivor = dev.crash(np.random.default_rng(0), keep_probability=0.3)
    checksum.LAUNCHES = 0
    got = dict(Log.open(survivor, LogConfig(capacity=FIG7_RING_BYTES))
               .iter_records())
    rec_launches = checksum.LAUNCHES
    lost = [l for l in written if l <= durable and got.get(l) != written[l]]
    bad = [l for l, p in got.items() if written.get(l) != p]
    log(f"strict crash: {len(written)} records written, durable-acked up to "
        f"lsn {durable}, {len(got)} recovered, {fill} + {rec_launches} launches")
    if lost or bad or sorted(got) != list(range(1, len(got) + 1)):
        raise AssertionError(f"strict crash lost {lost[:5]} / corrupt {bad[:5]}")
    if fill == 0 or rec_launches == 0:
        raise AssertionError("strict crash phase did not go through the kernel")
    return dict(written=len(written), durable=durable, recovered=len(got))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.log import REC_HDR_SIZE
    from repro_torch.kernels.checksum import checksum

    card = card_line()
    t0 = time.perf_counter()
    checksum.build()
    build_s = time.perf_counter() - t0
    log(card)                    # nvidia-smi's "name, power.limit" line
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    log(f"kernel build (nvcc, sm_90a): {build_s:.3f} s")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    base = np.random.default_rng(args.seed).integers(
        0, 256, 1 << 22, dtype=np.uint8).tobytes()
    extent = (REC_HDR_SIZE + RECORD_BYTES + 7) & ~7
    main_rows = RING_BYTES // extent
    kern = kernel_phase(gen, main_rows)
    main = main_path_phase(base)
    if main["acked"] != main_rows:
        raise AssertionError(f"ring held {main['acked']} records, "
                             f"expected {main_rows}")
    default_config_phase(base)
    strict_crash_phase(base)

    at = kern[f"batch({main_rows},259) 1GiB ring"]
    kernels = [dict(
        name="checksum_rows", route="cuda",
        source="src/repro_torch/csrc/checksum.cu",
        replaces="src/repro/kernels/checksum/checksum.py:30",
        launches=(main["fill_launches"] + main["recovery_launches"]
                  + main["rebuild_launches"]),
        max_abs_err=max(r["max_abs_err"] for r in kern.values()),
        ms=at["ms"], plain_ms=at["plain_ms"], bound_ms=at["bound_ms"],
        bound_by=at["bound_by"], library_ms=None)]
    print(json.dumps({"shapes": kern, "main_path": main}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
