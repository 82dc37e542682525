#!/usr/bin/env python3
"""Run the PyTorch port of the Arcadia log on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Builds the CUDA kernels of the lane-polynomial integrity hash and of the
Mamba2 SSD chunked scan from ``src/repro_torch/csrc`` (one nvcc each, in
parallel) and then, on the card:

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
                durable-acked record must come back byte-exact;
  ssd kernel    the SSD kernel against its plain version at every listed
                shape (fp32 within 1e-4, bf16 within 5e-2), with its
                median time, the plain version's time and its bound; in
                fp32 both against a float64 recurrence, where at N = 128
                the kernel may be no further from it than the plain one;
  serving       mamba2-130m at full width from --seed, saved as a
                checkpoint whose manifest commits through a replicated log
                (2 backups, W = 2 of 3, phash threshold 256 B), the log
                reopened and the params restored byte-exact, then 8
                prompts of 4096 tokens prefilled (one SSD launch per
                layer) and 32 greedy decode steps, with 4 teacher-forced
                decode steps held against the prefill logits;
  card vs cpu   the restored params in fp32, one 512-token prefill on the
                card (kernel) and on the CPU (plain): logits within 2e-3
                and the same next greedy token.  The teacher-forced and
                card-vs-CPU checks run again on a variant of the params in
                which the scan carries each mixer's output (at init it is
                mostly the 4-token conv).

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM CUDA-core rate, the closest
                               # published peak to the kernel's 32-bit
                               # integer multiply-adds (2 ops each), and
                               # the peak for fp32 products
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core rate
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


def replicated_deployment(capacity: int):
    """A local primary and two backups, W = 2 of 3, whose log hashes every
    record of at least PHASH_THRESHOLD bytes: (primary device, backup
    servers, replication group, log config)."""
    from repro_torch.core import (CostModel, LogConfig, PMEMDevice,
                                  ReplicaServer, ReplicationGroup, Transport,
                                  device_size)

    size = device_size(capacity)
    cost = CostModel()
    primary = PMEMDevice(size, mode="fast", cost=cost, name="node0/pmem")
    servers = [ReplicaServer(PMEMDevice(size, mode="fast", cost=cost,
                                        name=f"{b}/pmem"), server_id=b)
               for b in ("node1", "node2")]
    transports = [Transport(s, primary_id="node0", cost=cost)
                  for s in servers]
    group = ReplicationGroup(transports, 2, local_is_durable=True)
    cfg = LogConfig(capacity=capacity, write_quorum=2,
                    phash_threshold=PHASH_THRESHOLD)
    return primary, servers, group, cfg


def main_path_phase(base: bytes) -> dict:
    from repro_torch.core import (CopyAccessor, Log, LogConfig, LogFullError,
                                  quorum_recover)
    from repro_torch.kernels.checksum import checksum

    primary, servers, group, cfg = replicated_deployment(RING_BYTES)
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


# ------------------------------ SSD kernel ------------------------------ #

# (B, S, H, P, G, N, chunk): the shapes of tests/test_kernels.py, H=6 over
# G=3 groups, one short chunk at mamba2-130m's head widths, and the
# serving shape (8 prompts of 4096 tokens) in both dtypes
SSD_SHAPES = [((2, 64, 4, 32, 2, 16, 16), "float32"),
              ((1, 128, 2, 64, 1, 32, 32), "float32"),
              ((2, 64, 4, 32, 4, 16, 64), "float32"),
              ((1, 64, 2, 32, 1, 16, 16), "bfloat16"),
              ((1, 96, 6, 16, 3, 8, 16), "float32"),
              ((1, 100, 24, 64, 1, 128, 256), "float32"),
              ((8, 4096, 24, 64, 1, 128, 256), "bfloat16"),
              ((8, 4096, 24, 64, 1, 128, 256), "float32")]
SSD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}   # tests/test_kernels.py
SERVE_BATCH, SERVE_PROMPT, SERVE_DECODE = 8, 4096, 32
DEV = "cuda"
# teacher-forced decode against prefill, bf16 logits below 1 in magnitude:
# about five bf16 spacings (2^-8) at init, where each mixer's output is
# mostly its 4-token conv; 0.1 where the scan carries the mixer (the same
# check on the CPU gave 0.0215 there), since every layer's scan output is rounded
# to bf16 at other places on the two paths
TEACHER_TOL = {"init": 2e-2, "scan-dominated": 0.1}


def ssd_inputs(shape, dtype, seed: int):
    """Inputs on the card, drawn with numpy from ``seed``: those of
    tests/test_kernels.py, except that at mamba2-130m's head widths
    (N = 128) dt and A are drawn as the model initialises them (dt in
    [1e-3, 0.1], A = exp(A_log) in [1, 16]).  With the tests' dt range the
    chunk's cumulative decay nears -200 at Q = 256, where the fp32 plain
    version itself is 3e-4 to 1e-3 from a float64 recurrence (the float64
    check is tests/test_torch_cuda.py's)."""
    B, S, H, P, G, N, _ = shape
    rng = np.random.default_rng(seed)
    mixer = N == 128
    dt = rng.uniform(1e-3, 0.1, (B, S, H)) if mixer else \
        rng.uniform(0.05, 0.9, (B, S, H))
    a_log = np.log(rng.uniform(1.0, 16.0, H)) if mixer else \
        rng.uniform(-1.0, 0.5, H)
    cast = getattr(torch, dtype)
    t = lambda a, dt=torch.float32: torch.from_numpy(  # noqa: E731
        np.asarray(a, np.float32)).to(DEV).to(dt)
    return (t(rng.standard_normal((B, S, H, P), np.float32), cast), t(dt),
            t(a_log), t(rng.standard_normal((B, S, G, N), np.float32), cast),
            t(rng.standard_normal((B, S, G, N), np.float32), cast))


def ssd_bound_ms(shape, dtype) -> tuple[float, str]:
    """Least time for the scan: inputs read and outputs written once at the
    HBM rate, against its operations — the causal half of the intra-chunk
    products, Q(Q+1)(N+P) per chunk, plus 4·Q·N·P for the inter-chunk term
    and the state update — at the peak rate for the dtype (bf16 tensor
    cores; fp32 CUDA cores)."""
    B, S, H, P, G, N, chunk = shape
    Q = min(chunk, S)
    el = 2 if dtype == "bfloat16" else 4
    n_bytes = (2 * B * S * H * P * el + B * S * H * 4 + H * 4
               + 2 * B * S * G * N * el + B * H * P * N * 4)
    ops = B * H * (S // Q) * (Q * (Q + 1) * (N + P) + 4 * Q * N * P)
    rate = BF16_OPS_PER_S if dtype == "bfloat16" else FP32_OPS_PER_S
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ssd_kernel_phase(seed: int) -> dict:
    from repro_torch.kernels.ssd_scan import ops, ref

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    results = {}
    for k, (shape, dtype) in enumerate(SSD_SHAPES):
        args = ssd_inputs(shape, dtype, seed + k)
        chunk = shape[-1]
        y, st = ops.ssd(*args, chunk=chunk)
        y_ref, st_ref = ref.ssd_reference(*args, chunk=chunk)
        torch.cuda.synchronize()
        tol = SSD_TOL[dtype]
        err = 0.0
        for got, want in ((y, y_ref), (st, st_ref)):
            got, want = got.float(), want.float()
            if not torch.isfinite(got).all():
                raise AssertionError(f"SSD {shape} {dtype}: non-finite output")
            err = max(err, float((got - want).abs().max()))
            if not torch.allclose(got, want, atol=tol, rtol=tol):
                raise AssertionError(
                    f"SSD {shape} {dtype}: kernel differs from plain version "
                    f"by {float((got - want).abs().max())} (tolerance {tol})")
        err64 = {}
        if dtype == "float32":         # both versions against float64
            exact = ref.ssd_sequential_oracle(*(a.double() for a in args))
            for side, outs in (("kernel", (y, st)), ("plain", (y_ref, st_ref))):
                err64[side] = max(float(((o.double() - e).abs()
                                         / (1 + e.abs())).max())
                                  for o, e in zip(outs, exact))
            log(f"kernel ssd{shape} float32: max |err| / (1 + |exact|) "
                f"against float64, kernel {err64['kernel']:.3e}, plain "
                f"{err64['plain']:.3e}")
            del exact
            # at mamba2-130m's state width the chunk's decays run long
            if shape[5] == 128 and err64["kernel"] > err64["plain"]:
                raise AssertionError(f"SSD {shape}: kernel further from "
                                     f"float64 than the plain version")
        big = shape[0] * shape[1] > 4096
        ms = timed_ms(lambda: ops.ssd(*args, chunk=chunk), 10 if big else 20,
                      flush)
        plain = timed_ms(lambda: ref.ssd_reference(*args, chunk=chunk),
                         3 if big else 20, flush)
        b, by = ssd_bound_ms(shape, dtype)
        name = f"ssd{shape} {dtype}"
        results[name] = dict(shape=list(shape), dtype=dtype, max_abs_err=err,
                             tol=tol, ms=ms, plain_ms=plain, bound_ms=b,
                             bound_by=by, err_from_float64=err64)
        log(f"kernel {name}: max abs err {err:.3e} (within {tol} + "
            f"{tol}·|plain|), {ms:.6f} ms, plain {plain:.6f} ms, "
            f"bound {b:.6f} ms ({by})")
        del args, y, st, y_ref, st_ref
    torch.cuda.empty_cache()
    return results


# ------------------------- serving mamba2-130m -------------------------- #

def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def serving_phase(seed: int) -> dict:
    """Save -> reopen -> restore -> prefill -> decode, at full width."""
    from repro_torch.checkpoint import (CheckpointManager, ObjectStore,
                                        ReplicatedStore)
    from repro_torch.configs import get_config
    from repro_torch.core import Log, LogConfig
    from repro_torch.kernels.checksum import checksum
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.tree import leaf_paths

    cfg = get_config("mamba2-130m")
    out: dict = {"arch": cfg.name, "n_layers": cfg.n_layers,
                 "param_count": cfg.param_count()}
    gen = torch.Generator(device=DEV).manual_seed(seed)
    params = M.init_params(cfg, gen, device=DEV)
    prompts = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT))).to(DEV)

    stores = [ObjectStore(f"store{i}") for i in range(3)]
    store = ReplicatedStore(stores, write_quorum=2)
    primary, _, group, log_cfg = replicated_deployment(1 << 20)
    checksum.LAUNCHES = 0
    ssd_scan.LAUNCHES = 0
    try:
        wal = Log.create(primary, log_cfg, repl=group, device=DEV)
        t0 = time.perf_counter()
        mgr = CheckpointManager(store, wal)
        lsn = mgr.save(0, params, extra={"arch": cfg.name, "seed": seed},
                       sync=True)
        if wal.durable_lsn < lsn:
            raise AssertionError("sync save returned before its manifest "
                                 "was durable")
        group.drain()
        mgr.close()
        out["save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        relog = Log.open(primary, LogConfig(capacity=log_cfg.capacity),
                         device=DEV)
        template = M.init_params(cfg, torch.Generator(device=DEV
                                                      ).manual_seed(seed + 1),
                                 device=DEV)
        reader = CheckpointManager(store, relog)
        step, restored, extra = reader.restore(template)
        reader.close()
        torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
    finally:
        group.shutdown()
    out["checkpoint_launches"] = checksum.LAUNCHES
    saved, got = dict(leaf_paths(params)), dict(leaf_paths(restored))
    bad = [n for n in saved if n not in got
           or not bitwise_equal(saved[n], got[n])]
    if step != 0 or extra.get("seed") != seed or bad or set(got) != set(saved):
        raise AssertionError(f"restore: step {step}, extra {extra}, "
                             f"leaves differing {bad[:5]}")
    if out["checkpoint_launches"] < 3:
        raise AssertionError("the manifest commit and the reopen did not go "
                             "through the checksum kernel")
    log(f"serving checkpoint: {len(saved)} leaves "
        f"({out['param_count']} params) saved at lsn {lsn} (W=2 of 3 log, "
        f"2 of 3 stores) in {out['save_s']:.3f} s, reopened and restored "
        f"byte-exact in {out['restore_s']:.3f} s, "
        f"{out['checkpoint_launches']} checksum launches")
    del params, template

    served = M.cast_params(restored, cfg)
    res = serve.generate(served, cfg, prompts, SERVE_DECODE + 1)
    out["ssd_launches"] = ssd_scan.LAUNCHES
    out["checksum_launches"] = checksum.LAUNCHES
    if out["ssd_launches"] != cfg.n_layers:
        raise AssertionError(f"prefill made {out['ssd_launches']} SSD "
                             f"launches, expected {cfg.n_layers}")
    logits = res.prefill_logits
    if tuple(logits.shape) != (SERVE_BATCH, SERVE_PROMPT, cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                             f"not finite or not [B,S,V]")
    toks = res.tokens
    if tuple(toks.shape) != (SERVE_BATCH, SERVE_DECODE + 1) or \
            int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"decoded tokens {tuple(toks.shape)} out of range")
    n_tok = SERVE_BATCH * SERVE_PROMPT
    out.update(
        prefill_ms=res.prefill_s * 1e3,
        prefill_tokens_per_s=n_tok / res.prefill_s,
        decode_ms_per_step=res.decode_s * 1e3 / res.decode_steps,
        decode_tokens_per_s=SERVE_BATCH * res.decode_steps / res.decode_s,
        decode_steps=res.decode_steps,
        logits_abs_max=float(logits.float().abs().max()))
    log(f"serving prefill: {SERVE_BATCH} x {SERVE_PROMPT} tokens in "
        f"{out['prefill_ms']:.3f} ms ({out['prefill_tokens_per_s']:.1f} tok/s), "
        f"{out['ssd_launches']} SSD launches; decode: {res.decode_steps} "
        f"steps, {out['decode_ms_per_step']:.3f} ms/step "
        f"({out['decode_tokens_per_s']:.1f} tok/s)")

    # teacher-forced decode from a shorter prefill must reproduce the
    # prefill logits (tests/test_arch_smoke.py's check, in bf16), with the
    # restored params and with a variant in which the scan matters
    cut = SERVE_PROMPT - cfg.ssm_chunk
    want = logits[:, cut:cut + 4].float().clone()
    del logits, res
    variants = {"init": (served, want)}
    dominated = M.cast_params(scan_dominated(restored), cfg)
    full, _ = M.serve_step(dominated, cfg, {"tokens": prompts}, None, None)
    variants["scan-dominated"] = (dominated, full[:, cut:cut + 4].float()
                                  .clone())
    del full
    for name, (p, want) in variants.items():
        cache = M.init_cache(cfg, SERVE_BATCH, SERVE_PROMPT, device=DEV)
        _, cache = M.serve_step(p, cfg, {"tokens": prompts[:, :cut]},
                                cache, 0)
        diffs = []
        for j in range(4):
            step_logits, cache = M.serve_step(
                p, cfg, {"tokens": prompts[:, cut + j:cut + j + 1]}, cache,
                cut + j)
            diffs.append(float((step_logits[:, 0].float() - want[:, j]
                                ).abs().max()))
        out[f"teacher_forced_max_abs_diff[{name}]"] = max(diffs)
        log(f"serving teacher-forced decode at {cut}..{cut + 3}, {name} "
            f"params: max abs diff {max(diffs):.4e} against the prefill "
            f"logits (tolerance {TEACHER_TOL[name]}; logits up to "
            f"{float(want.abs().max()):.3f})")
        if not max(diffs) <= TEACHER_TOL[name]:
            raise AssertionError(f"teacher-forced decode diverges: {diffs}")
    out["restored"] = restored
    return out


def scan_dominated(params):
    """``params`` with each mixer's output carried by its SSD scan: the
    conv weights at the 1/sqrt(width) scale (0.5) instead of the init's
    0.02 cap, and no D skip.  At the init's scale each mixer's output is
    almost all its 4-token conv — changing the first 128 of 512 tokens
    moves the fp32 logits by about 2e-6 — so end-to-end checks at init
    see little of the scan; here they move by about 0.08."""
    from repro_torch.tree import tree_map

    out = tree_map(lambda t: t, params)
    ssm = out["blocks"]["l0"]["ssm"]
    ssm["conv_w"] = ssm["conv_w"] * 25.0
    ssm["D_skip"] = torch.zeros_like(ssm["D_skip"])
    return out


def card_vs_cpu_phase(restored, seed: int) -> dict:
    """The same params in fp32 compute, as restored and scan-dominated: one
    prefill on the card (kernel) and one on the CPU (plain) each, logits
    within 2e-3 (tests/test_arch_smoke.py's decode tolerance), the same
    next greedy token."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map

    cfg = replace(get_config("mamba2-130m"), compute_dtype="float32")
    toks = torch.from_numpy(np.random.default_rng(seed + 7).integers(
        0, cfg.vocab_size, (1, 512)))
    out = {}
    for name, params in (("init", restored),
                         ("scan-dominated", scan_dominated(restored))):
        before = ssd_scan.LAUNCHES
        card, _ = M.serve_step(params, cfg, {"tokens": toks.to(DEV)}, None,
                               None)
        card = card.cpu()
        if ssd_scan.LAUNCHES - before != cfg.n_layers:
            raise AssertionError("the card's prefill did not go through the "
                                 "kernel")
        host = tree_map(lambda t: t.cpu(), params)
        plain, _ = M.serve_step(host, cfg, {"tokens": toks}, None, None)
        if ssd_scan.LAUNCHES - before != cfg.n_layers:
            raise AssertionError("the CPU prefill launched the kernel")
        diff = float((card - plain).abs().max())
        same = bool(torch.equal(card[:, -1].argmax(-1),
                                plain[:, -1].argmax(-1)))
        agree = float((card.argmax(-1) == plain.argmax(-1)).float().mean())
        log(f"card vs cpu (fp32, 1 x 512, {name} params): max abs logit diff "
            f"{diff:.3e} (tolerance 2e-3), next greedy token equal: {same}, "
            f"greedy tokens equal at {agree:.4f} of positions")
        if not (torch.allclose(card, plain, atol=2e-3, rtol=2e-3) and same):
            raise AssertionError(f"card and CPU disagree ({name} params)")
        out[name] = dict(max_abs_diff=diff, next_token_equal=same,
                         greedy_agreement=agree)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.log import REC_HDR_SIZE
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.checksum import checksum
    from repro_torch.kernels.ssd_scan import ssd_scan

    # fp32 on the card in full fp32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    t0 = time.perf_counter()
    sources = [checksum.SOURCE, ssd_scan.SOURCE]
    with ThreadPoolExecutor(len(sources)) as pool:   # one nvcc per source
        list(pool.map(nvcc.build, sources))         # re-raises a failure
    build_s = time.perf_counter() - t0
    log(card)                    # nvidia-smi's "name, power.limit" line
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    log(f"kernel build (nvcc, sm_90a, 2 sources in parallel): {build_s:.3f} s")

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
    ssd = ssd_kernel_phase(args.seed)
    serving = serving_phase(args.seed)
    cross = card_vs_cpu_phase(serving.pop("restored"), args.seed)

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
    serve_at = ssd[f"ssd({SERVE_BATCH}, {SERVE_PROMPT}, 24, 64, 1, 128, 256) "
                   f"bfloat16"]
    kernels.append(dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/ssd_scan.py:29",
        launches=serving["ssd_launches"],
        max_abs_err=max(r["max_abs_err"] for r in ssd.values()),
        ms=serve_at["ms"], plain_ms=serve_at["plain_ms"],
        bound_ms=serve_at["bound_ms"], bound_by=serve_at["bound_by"],
        library_ms=None))
    print(json.dumps({"shapes": kern, "main_path": main, "ssd_shapes": ssd,
                      "serving": serving, "card_vs_cpu": cross}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
