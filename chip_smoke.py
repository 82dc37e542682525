#!/usr/bin/env python3
"""Run the PyTorch port of the Arcadia log on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Builds the CUDA kernels of the lane-polynomial integrity hash, of the
Mamba2 SSD chunked scan (tensor-core and CUDA-core sources) and of forward
flash attention from ``src/repro_torch/csrc`` (one nvcc per source, in
parallel) and then, on the card:

  kernel        the hash against its plain PyTorch version, bit-exact, at
                every listed shape, each on the route its row length picks
                (one warp a row up to 4096 lanes, block chunks and atomics
                above), with the wrapper's median time, the short-row
                kernel's time alone (100 launches replayed from a CUDA
                graph), the plain version's time and the HBM bound; and the
                log's per-wave hash of a pinned (64, 259) matrix by host
                clock, with the device operations it issues;
  main path     a replicated log (local primary + 2 backups, W = 2 of 3)
                with a 1 GiB ring of 1 KiB records hashed by the kernel
                (phash threshold 256 B), filled with batched appends until
                the ring is full, reopened and replayed, then rebuilt by
                quorum recovery from the two backups with the primary lost;
                every hash launch of the three on the short-row kernel;
  health        on the same live ring: seeded bit rot in the payloads of
                48 records on node1 and 16 on node0 and in the LSN word of
                8 headers on node2, then one unbudgeted scrub pass over the
                three copies, which must find exactly the records whose
                bytes changed, repair every one from a clean copy and
                validate on the short-row kernel only (one launch a copy,
                one a repair); a second pass must be clean and the primary
                must replay every acked record;
  trim+resync   trim through LogLifecycle to the newest eighth, node2
                killed mid-wire, an eighth of the ring (128 MiB) appended
                at W = 2, node2 rejoined by the online resync: its image
                must equal the primary's byte for byte, and quorum
                recovery from node1 + node2 must replay every live acked
                record;
  router+kv     MultiTenantKV over a LogRouter of 4 shards on a 4-node
                placement (local+remote, 2 backups, W = 2, 64 MiB rings,
                group-commit engines): 8 producers put 1 KiB values until
                the rings are about half full, plus 4 values of 1 MiB a
                shard; a snapshot cut must show every acked put, and after
                one shard's primary is lost the router's recovery must
                rebuild tables equal to the acked puts, hashing the 1 MiB
                records on the long-row kernel;
  default cfg   build_replica_set with the default 1 MiB threshold and 64
                records of 1 MiB, reopened and verified;
  strict crash  the 16 MiB ring of 1 KiB records on a strict device,
                crashed with keep probability 0.3 and reopened: every
                durable-acked record must come back byte-exact;
  ssd kernel    the SSD kernels against their plain version at every
                listed shape (fp32 within 1e-4, bf16 within 5e-2 and, per
                (batch, head, chunk) block of y, within 2^-6 of the
                block's largest value), each case on the route the table
                names (bf16 at widths that are multiples of 16 and chunks
                of 64·k on the tensor cores, also as the mixer's strided
                views; the rest on the CUDA cores), with its median time,
                the plain version's time and its bound; in fp32 both
                against a float64 recurrence, where at N = 128 the kernel
                may be no further from it than the plain one; at the
                serving shape the scan of the second half alone and the
                scan with decays twice as fast must fail the block check,
                and the mixer's views and contiguous copies of them are
                timed in turns on the same data: the scan alone (20
                scans replayed from a CUDA graph), per call with the L2
                flushed, the host's time to issue a call, and each of the
                three launches' device time (torch.profiler);
  serving       mamba2-130m at full width from --seed, saved as a
                checkpoint whose manifest commits through a replicated log
                (2 backups, W = 2 of 3, phash threshold 256 B), the log
                reopened and the params restored byte-exact, then 8
                prompts of 4096 tokens prefilled (one SSD launch per
                layer, on the tensor cores) and 32 greedy decode steps,
                with 4 teacher-forced
                decode steps held against the prefill logits;
  card vs cpu   the restored params in fp32, one 512-token prefill on the
                card (kernel) and on the CPU (plain): logits within 2e-3
                and the same next greedy token.  The teacher-forced and
                card-vs-CPU checks run again on a variant of the params in
                which the scan carries each mixer's output (at init it is
                mostly the 4-token conv);
  flash kernel  the flash-attention kernels against their plain version
                (within tol·(1 + |plain|), tol 2e-5 fp32 / 3e-2 bf16, and
                per output row within 1e-4 / 2^-6 of the row's largest
                value) at the shapes of tests/test_kernels.py, a window
                narrower than a tile, ragged lengths, the bf16 twins of the
                mask variants at head dims 128 and 256, and the serving
                shapes of gemma2-9b (global and local layers, bf16 and
                fp32, and scores in the softcap's range) and qwen2-7b
                (bf16 and fp32), the bf16 ones as the layer's permuted
                views; each bf16
                case at head dim 64, 128 or 256 must launch the
                tensor-core kernel, every other case the CUDA-core one; a
                dropped window and a dropped softcap must fail the row
                check; with its median time, the plain version's, its
                bound and, where one PyTorch call computes the same
                function (SDPA, or compiled flex_attention at gemma2's
                shapes), that call's; then each flash kernel's registers,
                local (spill) bytes and shared bytes (a tensor-core kernel
                that spills fails);
  gemma2        gemma2-9b at full width (42 layers, bf16) from --seed:
                2 prompts of 8192 tokens prefilled (one flash launch per
                layer, on the tensor cores) and 32 greedy decode steps,
                then a prefill of 8128
                tokens and 4 teacher-forced decode steps held against the
                first prefill's logits, with the peak device memory;
  gemma2 cpu    gemma2-9b at full width cut to one block (2 layers, local
                and global), fp32: one 512-token prefill on the card
                (kernel) and on the CPU (plain), logits within 2e-3 and
                the same next greedy token, at init and with a 128-token
                window and scores in the softcap's range, where a dropped
                window, softcap or causal mask must each move the logits
                by more than 2e-3.

Every failure exits non-zero.  Without a CUDA card, or without the rest
of the repository beside it, the script fails before printing a result.
The last line of standard output is the JSON object
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the one before it lists the kernels ({"kernels": [...]}), and the one
before that the flash kernels' attributes.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import struct
import subprocess
import sys
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# compiled flex_attention, timed beside the flash kernel, keeps its build
# inside the checkout and compiles in this process (no worker pool)
os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                      str(ROOT / "src" / "repro_torch" / "_build" / "inductor"))
os.environ.setdefault("TRITON_CACHE_DIR",
                      str(ROOT / "src" / "repro_torch" / "_build" / "triton"))
os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")

import numpy as np  # noqa: E402
import torch  # noqa: E402

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


def kernel_alone_ms(fn, launches: int) -> float:
    """Device time of one call of ``fn`` alone: ``launches`` back-to-back
    calls captured in a CUDA graph (so no host time falls between them;
    what they allocate comes from the graph's pool) and replayed between
    CUDA events; the median of five replays, over ``launches``."""
    fn()                                               # build, warm up
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.cuda.graph(
            graph, stream=side, capture_error_mode="relaxed"):
        for _ in range(launches):
            fn()
    torch.cuda.synchronize()
    graph.replay()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del graph
    return float(np.median(times))


def log_wave_hash(rows: int, lanes: int, calls: int = 200) -> dict:
    """The log's per-wave hash (``core/log.py::_hash_lane_rows``) of a
    pinned [rows, lanes] lane matrix, by host clock: the median call, and
    the device operations one call issues (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import log as wal_mod

    dev = torch.device(DEV)
    host = wal_mod._lane_buffer(rows, lanes, dev)
    host.numpy()[:] = np.random.default_rng(rows).integers(
        -2 ** 31, 2 ** 31, (rows, lanes), dtype=np.int64).astype(np.int32)
    want = wal_mod._hash_lane_rows(host, torch.device("cpu"))
    if not np.array_equal(wal_mod._hash_lane_rows(host, dev), want):
        raise AssertionError("the log's wave hash differs on the card")
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        wal_mod._hash_lane_rows(host, dev)
        times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wal_mod._hash_lane_rows(host, dev)
    ops_ = [e.key for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA for _ in range(e.count)]
    return dict(host_ms=float(np.median(times)), device_ops=ops_)


def kernel_phase(gen: torch.Generator, main_rows: int) -> dict:
    from repro_torch.kernels.checksum import checksum, ops, ref

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
        rows, lanes = mat.shape
        route = checksum.route(lanes)
        before = (checksum.SHORT_ROW_LAUNCHES, checksum.LONG_ROW_LAUNCHES)
        got = ops.tensor_checksum_batch(mat)
        moved = (checksum.SHORT_ROW_LAUNCHES - before[0],
                 checksum.LONG_ROW_LAUNCHES - before[1])
        if moved != ((1, 0) if route == "short_rows" else (0, 1)):
            raise AssertionError(f"{name}: launches {moved} (short, long "
                                 f"rows), expected one on {route}")
        want = ref.checksum_lanes_2d(mat)
        err = int((got - want).abs().max())
        if err:
            raise AssertionError(f"{name}: kernel differs from plain version")
        big = rows * lanes > (1 << 24)
        ms = timed_ms(lambda: ops.tensor_checksum_batch(mat), 20, flush)
        alone = kernel_alone_ms(lambda: checksum.checksum_rows_cuda(mat),
                                100) if route == "short_rows" else None
        plain = timed_ms(lambda: ref.checksum_lanes_2d(mat), 5 if big else 20,
                         flush)
        b, by = bound_ms(rows, lanes)
        results[name] = dict(shape=[rows, lanes], route=route, max_abs_err=err,
                             ms=ms, kernel_alone_ms=alone, plain_ms=plain,
                             bound_ms=b, bound_by=by)
        alone_txt = "" if alone is None else f"kernel alone {alone:.6f} ms, "
        log(f"kernel {name} ({route}): exact, {alone_txt}wrapper {ms:.6f} ms, "
            f"plain {plain:.6f} ms, bound {b:.6f} ms ({by})")
        del mat, got, want
    wave = log_wave_hash(WAVE, 259)
    results["log wave hash (64,259)"] = wave
    log(f"kernel log wave hash (64, 259) from a pinned buffer: "
        f"{wave['host_ms']:.6f} ms a call (host clock), device operations "
        f"{wave['device_ops']}")
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


def zero_hash_counts() -> None:
    from repro_torch.kernels.checksum import checksum
    checksum.LAUNCHES = checksum.SHORT_ROW_LAUNCHES = 0
    checksum.LONG_ROW_LAUNCHES = 0


def hash_counts() -> dict:
    """The hash kernel's launches since the counts were last zeroed."""
    from repro_torch.kernels.checksum import checksum
    return dict(launches=checksum.LAUNCHES,
                short_rows=checksum.SHORT_ROW_LAUNCHES,
                long_rows=checksum.LONG_ROW_LAUNCHES)


def main_path_phase(base: bytes):
    """Fill, reopen and rebuild the 1 GiB ring; returns the phase's numbers
    and the live deployment (a ReplicaSet over the filled ring), which the
    health phases go on with and the caller shuts down."""
    from repro_torch.core import (CopyAccessor, Log, LogConfig, LogFullError,
                                  ReplicaSet, quorum_recover)
    from repro_torch.kernels.checksum import checksum

    primary, servers, group, cfg = replicated_deployment(RING_BYTES)
    out = {}
    try:
        wal = Log.create(primary, cfg, repl=group)
        rs = ReplicaSet(mode="local+remote", cfg=cfg, primary_id="node0",
                        primary_dev=primary, servers=servers,
                        transports=list(group.transports), group=group,
                        log=wal)
        checksum.LAUNCHES = checksum.SHORT_ROW_LAUNCHES = 0
        checksum.LONG_ROW_LAUNCHES = 0
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
        out["fill_short_row_launches"] = checksum.SHORT_ROW_LAUNCHES
        out["acked"] = acked
        out["digest"] = digest
        log(f"main fill: {acked} records of {RECORD_BYTES} B acked (W=2 of 3) "
            f"in {out['fill_s']:.3f} s, {out['fill_launches']} kernel launches")
        if out["fill_launches"] < acked // WAVE:
            raise AssertionError("complete_batch did not go through the kernel")

        checksum.LAUNCHES = checksum.SHORT_ROW_LAUNCHES = 0
        t0 = time.perf_counter()
        reopened = Log.open(primary, LogConfig(capacity=RING_BYTES))
        got = replay(reopened)
        out["open_iter_s"] = time.perf_counter() - t0
        out["recovery_launches"] = checksum.LAUNCHES
        out["recovery_short_row_launches"] = checksum.SHORT_ROW_LAUNCHES
        log(f"main reopen+replay: {got[0]} records in {out['open_iter_s']:.3f} s, "
            f"{out['recovery_launches']} kernel launches")
        if got != (acked, digest):
            raise AssertionError(f"replay {got} != acked {(acked, digest)}")
        if out["recovery_launches"] < 2:
            raise AssertionError("recovery scan did not go through the kernel")
        del reopened

        checksum.LAUNCHES = checksum.SHORT_ROW_LAUNCHES = 0
        t0 = time.perf_counter()
        accs = [CopyAccessor.for_device(s.server_id, s.device) for s in servers]
        img, report = quorum_recover(accs, cfg, write_quorum=2,
                                     local_name="node0-rebuilt")
        rebuilt = replay(Log.open(img, LogConfig(capacity=RING_BYTES)))
        out["rebuild_s"] = time.perf_counter() - t0
        out["rebuild_launches"] = checksum.LAUNCHES
        out["rebuild_short_row_launches"] = checksum.SHORT_ROW_LAUNCHES
        log(f"main primary-lost rebuild: {rebuilt[0]} records from "
            f"{report.chosen}, epoch {report.old_epoch}->{report.new_epoch}, "
            f"repair bytes {report.repair_bytes}, in {out['rebuild_s']:.3f} s, "
            f"{out['rebuild_launches']} kernel launches")
        if rebuilt != (acked, digest):
            raise AssertionError(f"rebuild {rebuilt} != acked {(acked, digest)}")
        if out["rebuild_launches"] < 4:
            raise AssertionError("quorum recovery did not go through the kernel")
        for part in ("fill", "recovery", "rebuild"):
            if out[f"{part}_short_row_launches"] != out[f"{part}_launches"]:
                raise AssertionError(
                    f"{part}: {out[f'{part}_launches']} checksum launches, "
                    f"{out[f'{part}_short_row_launches']} on the short-row "
                    f"kernel (every 1 KiB record row must take it)")
    except BaseException:
        group.shutdown()
        raise
    return out, rs


# ------------------------- health on the 1 GiB ring ------------------------ #

def health_phase(rs, acked: int, digest: int, seed: int) -> dict:
    """Seeded media damage on the main path's three copies (payload bit rot
    in 48 records on node1 and 16 on node0, the LSN word of 8 headers on
    node2, all different records), then one unbudgeted scrub pass over the
    three copies: it must find exactly the records whose bytes changed,
    repair each from a clean copy, validate on the short-row kernel (one
    launch a copy, one a repaired record), leave a clean second pass and a
    primary that replays every acked record."""
    from repro_torch.core import ScrubConfig, Scrubber
    from repro_torch.core.log import REC_HDR_SIZE

    wal = rs.log
    copies = {rs.primary_id: rs.primary_dev}
    copies.update({s.server_id: s.device for s in rs.servers})
    rng = np.random.default_rng(seed + 16)
    lsns = rng.choice(np.arange(1, acked + 1), 72, replace=False).tolist()
    plan = [("node1", l, "payload") for l in lsns[:48]] + \
        [("node0", l, "payload") for l in lsns[48:64]] + \
        [("node2", l, "header") for l in lsns[64:]]
    changed = set()
    for name, lsn, part in plan:
        rec, dev = wal._recs[lsn], copies[name]
        before = dev.read_tensor(rec.off, rec.extent)
        if part == "payload":
            dev.corrupt(rec.off + REC_HDR_SIZE, rec.size, rng, nbits=4)
        else:
            dev.corrupt(rec.off, 8, rng, nbits=3)
        if not torch.equal(before, dev.read_tensor(rec.off, rec.extent)):
            changed.add((name, lsn))
    scrubber = Scrubber(wal, copies=copies,
                        cfg=ScrubConfig(defer_when_busy=False))
    zero_hash_counts()
    t0 = time.perf_counter()
    first = scrubber.scrub_once(force=True)
    scrub_s = time.perf_counter() - t0
    launches = hash_counts()
    zero_hash_counts()
    second = scrubber.scrub_once(force=True)
    second_launches = hash_counts()
    zero_hash_counts()
    t0 = time.perf_counter()
    got = replay(wal)
    replay_s = time.perf_counter() - t0
    replay_launches = hash_counts()
    out = dict(planted=len(plan), changed=len(changed),
               corrupt=first.corrupt, repaired=first.repaired,
               unrepairable=first.unrepairable,
               scanned_records=first.scanned_records,
               scanned_bytes=first.scanned_bytes,
               repair_bytes=first.repair_bytes,
               repair_ranges=first.repair_ranges, scrub_s=scrub_s,
               scrub_launches=launches, second_pass_corrupt=second.corrupt,
               second_pass_launches=second_launches, replay_s=replay_s,
               replay_launches=replay_launches)
    log(f"health scrub: {len(plan)} records damaged ({len(changed)} changed), "
        f"{first.corrupt} found, {first.repaired} repaired, "
        f"{first.unrepairable} unrepairable, {first.scanned_bytes} bytes "
        f"scanned on {len(copies)} copies, {first.repair_bytes} repair bytes "
        f"in {first.repair_ranges} ranges, {scrub_s:.3f} s, hash launches "
        f"{launches}; second pass {second.corrupt} corrupt, "
        f"{second_launches}; primary replay {got[0]} records in "
        f"{replay_s:.3f} s")
    if set(map(tuple, first.corrupt_records)) != changed:
        raise AssertionError("scrub found other records than the damaged ones")
    if not (first.repaired == first.corrupt == len(changed)
            and first.unrepairable == 0):
        raise AssertionError(f"scrub repaired {first.repaired} of "
                             f"{first.corrupt}, {first.unrepairable} left")
    if second.corrupt or not second.complete:
        raise AssertionError("the second scrub pass was not clean")
    if got != (acked, digest):
        raise AssertionError(f"primary replays {got} after the scrub, "
                             f"acked {(acked, digest)}")
    want = dict(launches=len(copies) + first.repaired,
                short_rows=len(copies) + first.repaired, long_rows=0)
    if launches != want or second_launches != dict(
            launches=len(copies), short_rows=len(copies), long_rows=0):
        raise AssertionError(f"scrub hash launches {launches} then "
                             f"{second_launches}, expected {want} then "
                             f"one short-row launch a copy")
    return out


class TailSnapshot:
    """The checkpoint side of ``LogLifecycle`` for an application whose
    snapshot covers every record but the newest ``keep``: ``save`` names
    the last LSN it covers, ``gc`` trims the log up to it."""

    def __init__(self, log_obj, keep: int):
        self.log, self.keep, self.covered = log_obj, keep, 0

    def save(self, step, state, extra=None, sync=True) -> int:
        self.covered = self.log.durable_lsn - self.keep
        return self.covered

    def gc(self) -> int:
        self.log.trim(self.covered)
        return 0


def trim_resync_phase(rs, base: bytes, acked: int) -> dict:
    """On the same ring: trim through ``LogLifecycle`` to the newest eighth,
    kill node2 mid-wire, append an eighth of the ring (128 MiB) at W = 2
    (node0 + node1), rejoin
    node2 with the online resync; node2's image must equal the primary's,
    and quorum recovery from node1 + node2 alone must replay every live
    acked record."""
    from repro_torch.core import (CopyAccessor, Log, LogConfig,
                                  LogLifecycle, quorum_recover)
    from repro_torch.core.log import REC_HDR_SIZE

    wal = rs.log
    size = rs.primary_dev.size
    t0 = time.perf_counter()
    lc = LogLifecycle(TailSnapshot(wal, acked // 8), state_fn=lambda: None)
    trim = lc.checkpoint_and_trim()
    trim_s = time.perf_counter() - t0
    covered = lc.manager.covered
    rs.kill_backup_midwire("node2")
    extent = (REC_HDR_SIZE + RECORD_BYTES + 7) & ~7
    n_gap = (rs.cfg.capacity // 8) // extent         # 128 MiB of 1 GiB
    zero_hash_counts()
    t0 = time.perf_counter()
    for w in range(0, n_gap, WAVE):
        wal.append_batch([payload(acked + w + k, base)
                          for k in range(min(WAVE, n_gap - w))])
    gap_s = time.perf_counter() - t0
    gap_launches = hash_counts()
    t0 = time.perf_counter()
    resync = rs.recover_backup("node2")
    resync_s = time.perf_counter() - t0
    wal.drain()
    rs.group.drain()
    node2 = next(s for s in rs.servers if s.server_id == "node2")
    identical = torch.equal(rs.primary_dev.read_tensor(0, size),
                            node2.device.read_tensor(0, size))
    want_n, want_digest = 0, 0
    for i in list(range(covered, acked)) + list(range(acked, acked + n_gap)):
        want_digest = zlib.crc32(payload(i, base), want_digest)
        want_n += 1
    zero_hash_counts()
    t0 = time.perf_counter()
    accs = [CopyAccessor.for_device(s.server_id, s.device)
            for s in rs.servers]
    img, report = quorum_recover(accs, rs.cfg, write_quorum=2,
                                 local_name="rebuilt")
    got = replay(Log.open(img, LogConfig(capacity=rs.cfg.capacity)))
    rebuild_s = time.perf_counter() - t0
    rebuild_launches = hash_counts()
    out = dict(trimmed_upto=trim.trimmed_upto, head_lsn=trim.head_lsn,
               reclaimed_records=trim.reclaimed_records,
               reclaimed_bytes=trim.reclaimed_bytes, trim_s=trim_s,
               gap_records=n_gap, gap_s=gap_s, gap_launches=gap_launches,
               sealed_bytes=resync.sealed_bytes,
               catchup_bytes=resync.catchup_bytes,
               cutover_bytes=resync.cutover_bytes,
               repair_bytes=resync.repair_bytes,
               repair_fraction=resync.repair_bytes / size, resync_s=resync_s,
               image_identical=identical, live_records=want_n,
               rebuild_s=rebuild_s, rebuild_launches=rebuild_launches)
    log(f"trim+resync: trimmed to lsn {trim.trimmed_upto} ({trim.reclaimed_records} "
        f"records, {trim.reclaimed_bytes} bytes reclaimed) in {trim_s:.3f} s; "
        f"node2 killed, {n_gap} records ({n_gap * extent} bytes) appended at "
        f"W=2 in {gap_s:.3f} s ({gap_launches}); resync shipped "
        f"{resync.repair_bytes} bytes ({resync.repair_bytes / size:.4f} of "
        f"the {size}-byte image; sealed region {resync.sealed_bytes} bytes) "
        f"in {resync_s:.3f} s, image identical: {identical}; node1+node2 "
        f"rebuild replayed {got[0]} records in {rebuild_s:.3f} s "
        f"({rebuild_launches})")
    if not identical:
        raise AssertionError("the resynced node2 differs from the primary")
    if got != (want_n, want_digest):
        raise AssertionError(f"node1+node2 rebuild replayed {got}, live "
                             f"acked records {(want_n, want_digest)}")
    if trim.trimmed_upto != covered or gap_launches["long_rows"] \
            or rebuild_launches["long_rows"] \
            or gap_launches["launches"] < n_gap // WAVE:
        raise AssertionError("trim or hash routes off in the resync phase")
    return out


# ------------------------------ router + KV ------------------------------ #

ROUTER_SHARDS = 4
ROUTER_RING = 64 << 20
ROUTER_PRODUCERS = 8
ROUTER_WINDOW = 32
BIG_VALUE = 1 << 20


def router_kv_phase(base: bytes) -> dict:
    """A tenant of 4 shards on a 4-node placement (each local+remote, 2
    backups, W = 2, 64 MiB rings, group-commit engines): 8 producers put
    1 KiB values (YCSB's 10 x 100 B record) until the rings are about half
    full, plus 4 values of 1 MiB a shard (hashed on the long-row kernel);
    a snapshot cut must show every acked put; then one shard's primary is
    lost and the router's recovery from the survivors must rebuild tables
    equal to the acked puts."""
    import threading
    from collections import deque

    from repro_torch.apps.kvstore import MultiTenantKV
    from repro_torch.core import IngestConfig, ShardPlacement

    mkv = MultiTenantKV(ShardPlacement(nodes=("node0", "node1", "node2",
                                              "node3")))
    sids = mkv.add_tenant("ycsb", n_shards=ROUTER_SHARDS,
                          mode="local+remote", n_backups=2, write_quorum=2,
                          capacity=ROUTER_RING, ingest=IngestConfig())
    per_producer = ROUTER_SHARDS * (ROUTER_RING // 2) // (
        RECORD_BYTES + 64) // ROUTER_PRODUCERS
    acked: dict = {}
    lock = threading.Lock()

    def producer(t: int) -> None:
        mine, pend = {}, deque()
        for i in range(per_producer):
            key = f"user{t:02d}{i:08d}".encode()
            off = ((t * per_producer + i) * 4099) % (len(base) - RECORD_BYTES)
            val = base[off:off + RECORD_BYTES]
            pend.append(mkv.put_async("ycsb", key, val))
            mine[key] = val
            if len(pend) >= ROUTER_WINDOW:
                pend.popleft().wait(timeout=60)
        while pend:
            pend.popleft().wait(timeout=60)
        with lock:
            acked.update(mine)

    zero_hash_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=producer, args=(t,))
               for t in range(ROUTER_PRODUCERS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    put_s = time.perf_counter() - t0
    big = {sid: [] for sid in sids}
    j = 0
    while any(len(v) < 4 for v in big.values()):
        key = f"big{j:06d}".encode()
        sid = mkv._shard_for(b"ycsb", key)
        if len(big[sid]) < 4:
            big[sid].append(key)
            val = bytes([j & 0xFF]) + base[:BIG_VALUE - 1]
            mkv.put("ycsb", key, val)
            acked[key] = val
        j += 1
    fill_launches = hash_counts()
    n_puts = ROUTER_PRODUCERS * per_producer
    used = {sid: mkv.router.shard(sid).log.stats()["used"] / ROUTER_RING
            for sid in sids}
    t0 = time.perf_counter()
    cut, view = mkv.snapshot_view()
    cut_s = time.perf_counter() - t0
    if view.get(b"ycsb") != acked:
        raise AssertionError("the snapshot view differs from the acked puts")
    mkv.close()
    lost = f"node0/{sids[0]}"
    devices = {sid: {n: d for n, d in
                     mkv.router.shard(sid).rs.server_devices().items()
                     if n != lost} for sid in sids}
    zero_hash_counts()
    t0 = time.perf_counter()
    rec = mkv.router.recover(devices=devices)
    tables = mkv.recover_tables(rec.logs)
    recover_s = time.perf_counter() - t0
    rec_launches = hash_counts()
    out = dict(shards=ROUTER_SHARDS, puts=n_puts, put_s=put_s,
               records_per_s=n_puts / put_s, ring_used=used,
               fill_launches=fill_launches, cut_lsns=dict(cut.lsns),
               cut_s=cut_s, lost=lost, recovered=rec.records,
               recover_s=recover_s, recover_launches=rec_launches)
    log(f"router+kv: {n_puts} puts of {RECORD_BYTES} B from "
        f"{ROUTER_PRODUCERS} producers over {ROUTER_SHARDS} shards in "
        f"{put_s:.3f} s ({n_puts / put_s:.1f} records/s), rings used "
        f"{min(used.values()):.3f}-{max(used.values()):.3f}, plus 4 x 1 MiB a "
        f"shard ({fill_launches}); cut of {sum(cut.lsns.values())} records "
        f"in {cut_s:.3f} s; primary {lost} lost, {rec.records} records "
        f"recovered and replayed in {recover_s:.3f} s ({rec_launches})")
    if tables.get(b"ycsb") != acked:
        raise AssertionError("router recovery rebuilt other tables than the "
                             "acked puts")
    if fill_launches["short_rows"] or rec_launches["short_rows"] \
            or rec_launches["long_rows"] < 2 * ROUTER_SHARDS \
            or fill_launches["long_rows"] < 4 * ROUTER_SHARDS:
        raise AssertionError("1 MiB records must take the long-row kernel")
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

# (B, S, H, P, G, N, chunk), dtype, layout, route: the shapes of
# tests/test_kernels.py, H=6 over G=3 groups, one short chunk at
# mamba2-130m's head widths, and the serving shape (8 prompts of 4096
# tokens) in both dtypes; the bf16 twins that the tensor-core kernel takes
# (a chunk of 64, 3 groups, mamba2's widths in two chunks), and the serving
# shape as the mixer passes it: views of one conv output (token stride
# H·P + 2·G·N).  fp32, and bf16 at other widths, stay on the CUDA cores.
TC, CC = "tensor_cores", "cuda_cores"
SSD_SHAPES = [((2, 64, 4, 32, 2, 16, 16), "float32", "contiguous", CC),
              ((1, 128, 2, 64, 1, 32, 32), "float32", "contiguous", CC),
              ((2, 64, 4, 32, 4, 16, 64), "float32", "contiguous", CC),
              ((2, 64, 4, 32, 4, 16, 64), "bfloat16", "contiguous", TC),
              ((1, 64, 2, 32, 1, 16, 16), "bfloat16", "contiguous", CC),
              ((1, 96, 6, 16, 3, 8, 16), "float32", "contiguous", CC),
              ((1, 256, 6, 32, 3, 32, 64), "bfloat16", "contiguous", TC),
              ((1, 100, 24, 64, 1, 128, 256), "float32", "contiguous", CC),
              ((1, 100, 24, 64, 1, 128, 256), "bfloat16", "contiguous", CC),
              ((1, 512, 24, 64, 1, 128, 256), "bfloat16", "contiguous", TC),
              ((8, 4096, 24, 64, 1, 128, 256), "bfloat16", "contiguous", TC),
              ((8, 4096, 24, 64, 1, 128, 256), "bfloat16", "mixer views", TC),
              ((8, 4096, 24, 64, 1, 128, 256), "float32", "contiguous", CC)]
SSD_SERVE = (8, 4096, 24, 64, 1, 128, 256)
SSD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}   # tests/test_kernels.py
# bf16, per (batch, head, chunk) block of y: max|kernel - plain| / max|plain|.
# The elementwise 5e-2 is about a twentieth of a typical |y| (≈ 1), so it
# cannot see a small error spread over a block.  The tensor-core kernel
# rounds B·dt·decay and h_prev to bf16 (2^-9 of each term) and y itself,
# and splits the score tile into bf16 hi and lo parts (about 2^-17 of each
# term; one bf16 rounding of the tile missed the elementwise 5e-2 near y =
# 0 at the tests' draws by up to 1.53x); over up to 256 terms of either
# sign that reaches 2^-8 to 2^-7 of a block's largest |y| (the CPU mirror
# of its passes, tests/test_torch_ssd.py); 2^-6 leaves a factor of two.
SSD_BLOCK_TOL = 2.0 ** -6
SERVE_BATCH, SERVE_PROMPT, SERVE_DECODE = 8, 4096, 32
DEV = "cuda"
# teacher-forced decode against prefill, bf16 logits below 1 in magnitude:
# about five bf16 spacings (2^-8) at init, where each mixer's output is
# mostly its 4-token conv; 0.1 where the scan carries the mixer (the same
# check on the CPU gave 0.0215 there), since every layer's scan output is rounded
# to bf16 at other places on the two paths
TEACHER_TOL = {"init": 2e-2, "scan-dominated": 0.1}


def ssd_inputs(shape, dtype, seed: int, layout: str = "contiguous"):
    """Inputs on the card, drawn with numpy from ``seed``: those of
    tests/test_kernels.py, except that at mamba2-130m's head widths
    (N = 128) dt and A are drawn as the model initialises them (dt in
    [1e-3, 0.1], A = exp(A_log) in [1, 16]).  With the tests' dt range the
    chunk's cumulative decay nears -200 at Q = 256, where the fp32 plain
    version itself is 3e-4 to 1e-3 from a float64 recurrence (the float64
    check is tests/test_torch_cuda.py's).  Layout "mixer views": xh, Bm and
    Cm are views of one [B, S, H·P + 2·G·N] tensor, as the mixer's split of
    its conv output gives them."""
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
    xh, Bm, Cm = (t(rng.standard_normal((B, S, H, P), np.float32), cast),
                  t(rng.standard_normal((B, S, G, N), np.float32), cast),
                  t(rng.standard_normal((B, S, G, N), np.float32), cast))
    if layout == "mixer views":
        conv = torch.cat([xh.reshape(B, S, H * P), Bm.reshape(B, S, G * N),
                          Cm.reshape(B, S, G * N)], dim=-1)
        xi, bv, cv = torch.split(conv, [H * P, G * N, G * N], dim=-1)
        xh, Bm, Cm = (xi.reshape(B, S, H, P), bv.reshape(B, S, G, N),
                      cv.reshape(B, S, G, N))
    return xh, t(dt), t(a_log), Bm, Cm


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


def ssd_planted_faults(args, chunk: int, y_plain: torch.Tensor) -> dict:
    """The per-block check must fail a wrong scan: the kernel on the second
    half of the sequence alone (no state carried in) against the plain
    version's second half of the whole, and the kernel given A_log + ln 2
    (decays twice as fast).  Both run on the tensor cores."""
    from repro_torch.kernels.ssd_scan import ops, ssd_scan

    xh, dt, A_log, Bm, Cm = args
    h = xh.shape[1] // 2
    before = ssd_scan.TENSOR_CORE_LAUNCHES
    half, _ = ops.ssd(xh[:, h:], dt[:, h:], A_log, Bm[:, h:], Cm[:, h:],
                      chunk=chunk)
    fast, _ = ops.ssd(xh, dt, A_log + float(np.log(2.0)), Bm, Cm, chunk=chunk)
    if ssd_scan.TENSOR_CORE_LAUNCHES - before != 2:
        raise AssertionError("the planted faults did not run on the tensor "
                             "cores")
    out = {"second half alone": block_err(half, y_plain[:, h:], chunk),
           "A_log + ln 2": block_err(fast, y_plain, chunk)}
    for name, err in out.items():
        if not err > SSD_BLOCK_TOL:
            raise AssertionError(f"SSD fault {name!r} passes the per-block "
                                 f"check ({err:.3e} <= {SSD_BLOCK_TOL})")
    return out


def ssd_layouts(args, chunk: int, flush: torch.Tensor) -> dict:
    """The mixer's views (``args``) against contiguous copies of them, on
    the same data, in turns (views, contiguous, contiguous, views): the
    scan alone (``kernel_alone_ms``, 20 scans), the wrapper per call with
    the L2 flushed (``timed_ms``), the host's time to issue one call to an
    idle card (median of 20), and each of the three launches' device time
    (torch.profiler over 10 scans: each launch's mean over the launches
    it recorded, and their counts; it can miss the first scans' launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.ssd_scan import ops

    xh, dt, A_log, Bm, Cm = args
    layouts = {"mixer views": args,
               "contiguous": (xh.contiguous(), dt, A_log, Bm.contiguous(),
                              Cm.contiguous())}
    out = {k: dict(alone_ms=[], wrapper_ms=[], issue_ms=[]) for k in layouts}
    for name in ("mixer views", "contiguous", "contiguous", "mixer views"):
        scan = lambda: ops.ssd(*layouts[name], chunk=chunk)  # noqa: E731
        out[name]["alone_ms"].append(kernel_alone_ms(scan, 20))
        out[name]["wrapper_ms"].append(timed_ms(scan, 10, flush))
        issue = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scan()
            issue.append((time.perf_counter() - t0) * 1e3)
        out[name]["issue_ms"].append(float(np.median(issue)))
    for name, a in layouts.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                ops.ssd(*a, chunk=chunk)
            torch.cuda.synchronize()
        launches = [e for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA]
        if len(launches) != 3:
            raise AssertionError(f"SSD {name}: the profiler saw "
                                 f"{[e.key for e in launches]}, not the "
                                 f"three launches")
        kname = lambda e: re.search(  # noqa: E731
            r"\w+_kernel(<[^>]*>)?", e.key).group(0)
        out[name]["pass_ms"] = {kname(e): e.self_device_time_total
                                / e.count / 1e3 for e in launches}
        out[name]["pass_count"] = {kname(e): e.count for e in launches}
    return out


def block_err(got, want, chunk: int) -> float:
    from repro_torch.kernels.ssd_scan import ref

    return ref.chunk_block_rel_err(got, want, chunk)


def ssd_kernel_phase(seed: int) -> dict:
    """Each case: one scan on the route the table names (one launch count,
    one on the route's count), held against the plain version elementwise
    and, in bf16, per (batch, head, chunk) block; fp32 also against a
    float64 recurrence; planted faults at the serving shape."""
    from repro_torch.kernels.ssd_scan import ops, ref, ssd_scan

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    results = {}
    for k, (shape, dtype, layout, route) in enumerate(SSD_SHAPES):
        args = ssd_inputs(shape, dtype, seed + k, layout)
        chunk = shape[-1]
        name = f"ssd{shape} {dtype}" + ("" if layout == "contiguous"
                                        else f" {layout}")
        chosen = ssd_scan.route(args[0], args[3], args[4], chunk)
        if chosen != route:
            raise AssertionError(f"{name}: routed to {chosen}, expected "
                                 f"{route}")
        before = (ssd_scan.LAUNCHES, ssd_scan.TENSOR_CORE_LAUNCHES,
                  ssd_scan.CUDA_CORE_LAUNCHES)
        y, st = ops.ssd(*args, chunk=chunk)
        moved = (ssd_scan.LAUNCHES - before[0],
                 ssd_scan.TENSOR_CORE_LAUNCHES - before[1],
                 ssd_scan.CUDA_CORE_LAUNCHES - before[2])
        if moved != ((1, 1, 0) if route == TC else (1, 0, 1)):
            raise AssertionError(f"{name}: launches {moved} (all, tensor "
                                 f"cores, CUDA cores), expected one on {route}")
        y_ref, st_ref = ref.ssd_reference(*args, chunk=chunk)
        torch.cuda.synchronize()
        tol = SSD_TOL[dtype]
        err = 0.0
        for got, want in ((y, y_ref), (st, st_ref)):
            got, want = got.float(), want.float()
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name}: non-finite output")
            err = max(err, float((got - want).abs().max()))
            if not torch.allclose(got, want, atol=tol, rtol=tol):
                raise AssertionError(
                    f"{name}: kernel differs from plain version "
                    f"by {float((got - want).abs().max())} (tolerance {tol})")
        blk = faults = None
        if dtype == "bfloat16":
            blk = block_err(y, y_ref, chunk)
            if not blk <= SSD_BLOCK_TOL:
                raise AssertionError(f"{name}: a (batch, head, chunk) block "
                                     f"of y is {blk:.3e} of its largest value "
                                     f"off (tolerance {SSD_BLOCK_TOL})")
            if shape == SSD_SERVE and layout == "contiguous":
                faults = ssd_planted_faults(args, chunk, y_ref)
        err64 = {}
        if dtype == "float32":         # both versions against float64
            exact = ref.ssd_sequential_oracle(*(a.double() for a in args))
            for side, outs in (("kernel", (y, st)), ("plain", (y_ref, st_ref))):
                err64[side] = max(float(((o.double() - e).abs()
                                         / (1 + e.abs())).max())
                                  for o, e in zip(outs, exact))
            log(f"kernel {name}: max |err| / (1 + |exact|) "
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
        turns = ssd_layouts(args, chunk, flush) \
            if layout == "mixer views" else None
        results[name] = dict(shape=list(shape), dtype=dtype, layout=layout,
                             route=route, max_abs_err=err, tol=tol,
                             block_rel_err=blk, block_tol=SSD_BLOCK_TOL,
                             planted_fault_block_rel_err=faults, ms=ms,
                             plain_ms=plain, bound_ms=b, bound_by=by,
                             err_from_float64=err64, layouts=turns)
        blk_txt = "" if blk is None else f", block err {blk:.3e} (within " \
            f"{SSD_BLOCK_TOL:.4g})"
        fault_txt = "" if faults is None else "; planted faults: " + ", ".join(
            f"{f} {e:.3e} of a block off" for f, e in faults.items())
        log(f"kernel {name} ({route}): max abs err {err:.3e} (within {tol} + "
            f"{tol}·|plain|){blk_txt}{fault_txt}; {ms:.6f} ms, plain "
            f"{plain:.6f} ms, bound {b:.6f} ms ({by})")
        for lay, t in (turns or {}).items():
            log(f"kernel {name}, in turns as {lay}: alone {t['alone_ms']} "
                f"ms, per call {t['wrapper_ms']} ms, issue {t['issue_ms']} "
                f"ms (host), launches {t['pass_ms']} ms (device) of "
                f"{t['pass_count']} recorded")
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
    ssd_scan.LAUNCHES = ssd_scan.TENSOR_CORE_LAUNCHES = 0
    ssd_scan.CUDA_CORE_LAUNCHES = 0
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
    out["ssd_tensor_core_launches"] = ssd_scan.TENSOR_CORE_LAUNCHES
    out["checksum_launches"] = checksum.LAUNCHES
    if out["ssd_launches"] != cfg.n_layers or \
            ssd_scan.TENSOR_CORE_LAUNCHES != cfg.n_layers:
        raise AssertionError(f"prefill made {out['ssd_launches']} SSD "
                             f"launches ({ssd_scan.TENSOR_CORE_LAUNCHES} on "
                             f"the tensor cores), expected {cfg.n_layers} on "
                             f"the tensor cores")
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
        f"{out['ssd_launches']} SSD launches "
        f"({out['ssd_tensor_core_launches']} on the tensor cores); decode: "
        f"{res.decode_steps} "
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


# ---------------------------- flash attention ---------------------------- #

def flash_case(name, shape, dtype, *, layout="bhsd", q_mul=1.0, fault=None,
               **kw) -> dict:
    """One shape of the flash phase.  ``layout`` "bshd" makes q, k, v
    permuted [B,S,H,D] views, as the layer passes them; ``q_mul`` scales q
    (16 puts the scores in the softcap's range); ``fault`` names mask
    options of a wrong function the check must be able to tell apart."""
    return dict(name=name, shape=shape, dtype=dtype, layout=layout,
                q_mul=q_mul, fault=fault, kw=kw)


# the shapes of tests/test_kernels.py (four causal, four mask variants,
# bf16), a window narrower than a 64-row tile (the first tile some rows
# visit is wholly masked for them and must be wiped), ragged lengths, and
# the serving shapes at 2 x 8192 tokens: gemma2-9b's global and local
# layers and qwen2-7b's width (28 heads over 4) in bf16 as the layer lays
# them out, gemma2's global layer with scores in the softcap's range, and
# both gemma2 layers and qwen2's width in fp32 (the CUDA-core route's
# yardsticks: compiled flex_attention and SDPA)
G2 = (2, 16, 8, 8192, 256)
FLASH_CASES = [
    flash_case("causal (2, 4, 2, 256, 64)", (2, 4, 2, 256, 64), "float32", causal=True),
    flash_case("causal (1, 8, 8, 128, 128)", (1, 8, 8, 128, 128), "float32", causal=True),
    flash_case("causal (2, 2, 1, 512, 32)", (2, 2, 1, 512, 32), "float32", causal=True),
    flash_case("causal (1, 4, 2, 384, 64)", (1, 4, 2, 384, 64), "float32", causal=True),
    flash_case("full (1, 4, 2, 256, 64)", (1, 4, 2, 256, 64), "float32", causal=False),
    flash_case("window 128 (1, 4, 2, 256, 64)", (1, 4, 2, 256, 64), "float32",
               causal=True, window=128),
    flash_case("cap 50 (1, 4, 2, 256, 64)", (1, 4, 2, 256, 64), "float32",
               causal=True, cap=50.0),
    flash_case("window 64 cap 30 (1, 4, 2, 256, 64)", (1, 4, 2, 256, 64),
               "float32", causal=True, window=64, cap=30.0),
    flash_case("causal (1, 2, 2, 256, 64)", (1, 2, 2, 256, 64), "bfloat16", causal=True),
    flash_case("window 16 below a tile (1, 4, 2, 256, 64)", (1, 4, 2, 256, 64),
               "float32", causal=True, window=16),
    flash_case("ragged (1, 4, 2, 1000, 64)", (1, 4, 2, 1000, 64), "float32",
               causal=True, window=100),
    flash_case("ragged (2, 16, 8, 1000, 256)", (2, 16, 8, 1000, 256),
               "bfloat16", causal=True, window=300, cap=50.0),
    flash_case(f"gemma2 global {G2}", G2, "bfloat16", layout="bshd",
               causal=True, cap=50.0),
    flash_case(f"gemma2 local {G2}", G2, "bfloat16", layout="bshd",
               fault=dict(window=None), causal=True, window=4096, cap=50.0),
    flash_case(f"gemma2 global {G2} scores x16", G2, "bfloat16", layout="bshd",
               q_mul=16.0, fault=dict(cap=None), causal=True, cap=50.0),
    flash_case("qwen2 width (2, 28, 4, 8192, 128)", (2, 28, 4, 8192, 128),
               "bfloat16", layout="bshd", causal=True),
    flash_case(f"gemma2 global {G2}", G2, "float32", causal=True, cap=50.0),
    flash_case(f"gemma2 local {G2}", G2, "float32", causal=True, window=4096,
               cap=50.0),
    flash_case("qwen2 width (2, 28, 4, 8192, 128)", (2, 28, 4, 8192, 128),
               "float32", causal=True),
]
# the fp32 mask variants' bf16 twins at the serving head dims, which the
# tensor-core kernel serves (key tiles of 128 at D 128, 64 at D 256), and a
# ragged length that neither its 128-row blocks nor its key tiles divide
for _D in (128, 256):
    _shape = (1, 4, 2, 256, _D)
    FLASH_CASES += [
        flash_case(f"full {_shape}", _shape, "bfloat16", causal=False),
        flash_case(f"window 128 {_shape}", _shape, "bfloat16", causal=True,
                   window=128),
        flash_case(f"cap 50 {_shape}", _shape, "bfloat16", causal=True,
                   cap=50.0),
        flash_case(f"window 64 cap 30 {_shape}", _shape, "bfloat16",
                   causal=True, window=64, cap=30.0),
        flash_case(f"window 16 below a tile {_shape}", _shape, "bfloat16",
                   causal=True, window=16)]
FLASH_CASES.append(flash_case("ragged (1, 4, 2, 1000, 128)",
                              (1, 4, 2, 1000, 128), "bfloat16", causal=True,
                              window=100))
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}   # tests/test_kernels.py
# the same check scaled to each output row: max over the row of
# |kernel - plain| / max over the row of |plain|.  q, k, v from randn
# average v over up to 8192 keys, so most outputs are about 0.02 and the
# elementwise bf16 tolerance is as large as they are.  In bf16 both
# outputs are rounded to bf16 (one spacing apart at most, 2^-7 of the
# row's largest value) and the plain version also rounds p to bf16 before
# the PV product (2^-9 of it); 2^-6 leaves a factor of two.  In fp32 the
# two differ only in the order of their fp32 sums.
FLASH_ROW_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over rows of max|got - want| / max|want| (rows: the last dim)."""
    got, want = got.float(), want.float()
    num = (got - want).abs().amax(-1)
    den = want.abs().amax(-1).clamp_min(torch.finfo(torch.float32).tiny)
    return float((num / den).max())


def flash_inputs(case: dict, seed: int):
    """q [B,H,S,D], k and v [B,KV,S,D] from the seed, in the case's dtype;
    for layout "bshd" views of [B,S,H,D] storage."""
    B, H, KV, S, D = case["shape"]
    gen = torch.Generator(device=DEV).manual_seed(seed)
    dt = getattr(torch, case["dtype"])
    out = []
    for n, heads in enumerate((H, KV, KV)):
        shape = (B, S, heads, D) if case["layout"] == "bshd" else \
            (B, heads, S, D)
        t = torch.randn(shape, device=DEV, generator=gen)
        if n == 0:
            t *= case["q_mul"]
        t = t.to(dt)
        out.append(t.transpose(1, 2) if case["layout"] == "bshd" else t)
    return out


def flex_library(q, k, v, kw):
    """One PyTorch call computing the same function as the kernel where
    SDPA cannot (a softcap or a window): compiled flex_attention with the
    softcap as its score_mod and the causal window as its block mask.
    Timed as a yardstick only; the port never calls it."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    causal, window, cap = kw.get("causal", True), kw.get("window"), \
        kw.get("cap")
    S = q.shape[2]

    def mask(b, h, qi, ki):
        ok = ki <= qi if causal else ki >= 0
        if window is not None:
            ok = ok & (ki > qi - window)
        return ok

    def score(s, b, h, qi, ki):
        return torch.tanh(s / cap) * cap

    block_mask = create_block_mask(mask, None, None, S, S, device=q.device)
    fn = torch.compile(flex_attention, dynamic=False)
    return lambda: fn(q, k, v, score_mod=score if cap is not None else None,
                      block_mask=block_mask, enable_gqa=True)


def attended_pairs(S: int, causal: bool, window) -> int:
    """(query, key) pairs the mask leaves: the work the function needs."""
    s = np.arange(S, dtype=np.int64)
    hi = s if causal else np.full(S, S - 1, dtype=np.int64)
    lo = np.maximum(0, s - window + 1) if window else np.zeros(S, np.int64)
    return int((hi - lo + 1).sum())


def flash_bound_ms(shape, kw, dtype) -> tuple[float, str]:
    """Least time for the attention: q, k, v read and o written once at the
    HBM rate, against 4·B·H·D operations per unmasked pair (the two
    products) at the peak rate for the dtype (bf16 tensor cores; fp32 CUDA
    cores)."""
    B, H, KV, S, D = shape
    el = 2 if dtype == "bfloat16" else 4
    n_bytes = (2 * B * H * S * D + 2 * B * KV * S * D) * el
    ops = 4 * B * H * D * attended_pairs(S, kw.get("causal", True),
                                         kw.get("window"))
    rate = BF16_OPS_PER_S if dtype == "bfloat16" else FP32_OPS_PER_S
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_kernel_phase(seed: int) -> dict:
    """Each case: one launch, held against the plain version elementwise
    (FLASH_TOL) and row by row (FLASH_ROW_TOL); where the case names a
    fault, the plain version of that wrong function must fail the row
    check.  Times of the kernel, the plain version and, where one PyTorch
    call computes the same function (SDPA without a softcap or a window,
    else flex_attention at the bf16 serving shapes), that call."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops, ref

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    results = {}
    for n, case in enumerate(FLASH_CASES):
        name, shape, kw, dtype = (case[x] for x in ("name", "shape", "kw",
                                                     "dtype"))
        S = shape[3]
        q, k, v = flash_inputs(case, seed + n)
        route = fa.tile_plan(q.dtype, shape[4]).route
        before = (fa.LAUNCHES, fa.TENSOR_CORE_LAUNCHES, fa.CUDA_CORE_LAUNCHES)
        got = ops.flash_attention(q, k, v, **kw)
        moved = (fa.LAUNCHES - before[0], fa.TENSOR_CORE_LAUNCHES - before[1],
                 fa.CUDA_CORE_LAUNCHES - before[2])
        if moved != ((1, 1, 0) if route == "tensor_cores" else (1, 0, 1)):
            raise AssertionError(f"flash {name} {dtype}: launches {moved} "
                                 f"(all, tensor cores, CUDA cores), expected "
                                 f"one on the {route} kernel")
        want = ref.attention_reference(q, k, v, **kw)
        torch.cuda.synchronize()
        tol, row_tol = FLASH_TOL[dtype], FLASH_ROW_TOL[dtype]
        if not torch.isfinite(got).all():
            raise AssertionError(f"flash {name} {dtype}: non-finite output")
        err = float((got.float() - want.float()).abs().max())
        row_err = row_rel_err(got, want)
        if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol) \
                or not row_err <= row_tol:
            raise AssertionError(
                f"flash {name} {dtype}: kernel differs from plain version by "
                f"{err} (tolerance {tol}), by {row_err} of a row's largest "
                f"value (tolerance {row_tol})")
        fault_err = None
        if case["fault"] is not None:
            wrong = ref.attention_reference(q, k, v, **{**kw, **case["fault"]})
            fault_err = row_rel_err(got, wrong)
            del wrong
            if not fault_err > row_tol:
                raise AssertionError(
                    f"flash {name}: the row check cannot tell the kernel from "
                    f"the plain version with {case['fault']} ({fault_err})")
        del got
        big = S >= 8192
        ms = timed_ms(lambda: ops.flash_attention(q, k, v, **kw),
                      5 if big else 20, flush)
        plain = timed_ms(lambda: ref.attention_reference(q, k, v, **kw),
                         3 if big else 20, flush)
        library = library_err = library_error = call = None
        if kw.get("cap") is None and kw.get("window") is None:
            call = "scaled_dot_product_attention"
        elif big and case["q_mul"] == 1.0:
            call = "flex_attention (compiled)"
        if call is not None:
            try:
                if call == "flex_attention (compiled)":
                    lib = flex_library(q, k, v, kw)
                else:
                    lib = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                        q, k, v, is_causal=kw["causal"], enable_gqa=True)
                library_err = row_rel_err(lib(), want)
                library = timed_ms(lib, 5 if big else 20, flush)
            except Exception as e:       # the yardstick only: recorded
                library_error = f"{type(e).__name__}: {e}"[:300]
        b, by = flash_bound_ms(shape, kw, dtype)
        key = f"{name} {dtype}"
        results[key] = dict(shape=list(shape), options=kw, dtype=dtype,
                            route=route, layout=case["layout"],
                            q_mul=case["q_mul"],
                            max_abs_err=err, tol=tol, row_rel_err=row_err,
                            row_tol=row_tol, fault=case["fault"],
                            fault_row_rel_err=fault_err, ms=ms,
                            plain_ms=plain, bound_ms=b, bound_by=by,
                            library=call, library_ms=library,
                            library_row_rel_err=library_err,
                            library_error=library_error)
        if call is None:
            lib_txt = "none"
        elif library_error is not None:
            lib_txt = f"{call} raised {library_error}"
        else:
            lib_txt = (f"{call} {library:.6f} ms (row err {library_err:.3e})")
        fault_txt = "" if fault_err is None else (
            f"; with {case['fault']} the plain version is {fault_err:.3e} "
            f"of a row off")
        q_txt = "" if case["q_mul"] == 1.0 else f" q x{case['q_mul']:g}"
        log(f"kernel flash {key} {kw} {case['layout']}{q_txt} ({route}): "
            f"max abs err {err:.3e} (within {tol} + {tol}·|plain|), row err "
            f"{row_err:.3e} (within {row_tol:.4g}){fault_txt}; {ms:.6f} ms, "
            f"plain {plain:.6f} ms, bound {b:.6f} ms ({by}), library "
            f"{lib_txt}")
        del q, k, v, want
        torch.cuda.empty_cache()
    return results


def flash_attributes() -> list:
    """``cudaFuncGetAttributes`` of each flash kernel: registers a thread,
    local (spill) bytes a thread, shared bytes a block (dynamic + static)
    and threads a block, for bf16 at the tensor-core head dims with and
    without a softcap and for fp32 at each CUDA-core width.  A tensor-core
    kernel that spills fails the run."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    out = []
    for dtype, dims, caps in ((torch.bfloat16, fa.TENSOR_CORE_HEAD_DIMS,
                               (False, True)),
                              (torch.float32, (32, 64, 128, 256), (False,))):
        for D in dims:
            for capped in caps:
                info = fa.kernel_info(dtype, D, capped)
                out.append(dict(
                    dtype=str(dtype).removeprefix("torch."), head_dim=D,
                    softcap=capped, route=info["route"],
                    registers=info["registers"],
                    local_bytes=info["local_bytes"],
                    shared_bytes=info["smem_bytes"]
                    + info["static_smem_bytes"],
                    threads=info["max_threads"]))
                if info["route"] == "tensor_cores" and info["local_bytes"]:
                    raise AssertionError(f"the tensor-core flash kernel spills "
                                         f"at D={D}: {info}")
    return out


# -------------------------- serving gemma2-9b --------------------------- #

GEMMA_BATCH, GEMMA_PROMPT, GEMMA_DECODE = 2, 8192, 32
GEMMA_CUT = GEMMA_PROMPT - 64        # teacher-forced positions 8128..8131
# teacher-forced decode against prefill, bf16 logits: at init the logits
# have a spread of about 0.12 (the tied embedding's 256000^-1/2 scale over
# 3584 dims) and reach about 0.6.  Prefill (flash kernel: fp32 softmax, the
# unnormalised P rounded to bf16 for the tensor cores, divided by the fp32
# sum at the end) and decode (plain direct path: p normalised, then rounded
# to bf16; other matmul shapes) round differently in each of 42 layers; a
# CPU rehearsal of the same check at 42 layers in bf16 (d_model 512 to
# 1024) differed by 1.4% to 1.7% of the largest logit.  0.05 is 13 bf16
# spacings at 0.5; a wrong window changes every local layer's normalised
# mix and moves logits by their spread.
GEMMA_TEACHER_TOL = 5e-2


def device_window(fn):
    """Run ``fn`` under torch.profiler: (its result, the window's wall ms,
    the device (kernel) ms, their ratio, and the five kernels that took
    the most device time).  Kernel times are the profiler's CUDA events
    only, so no op's time is counted twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return result, dict(
        wall_ms=wall_ms, device_ms=device_ms, busy_share=device_ms / wall_ms,
        top_kernels=[dict(name=e.key[:80], ms=e.self_device_time_total / 1e3,
                          count=e.count) for e in top])


def gemma2_serving_phase(seed: int) -> dict:
    """Full width, 42 layers, bf16: prefill 2 x 8192, 32 greedy decode
    steps; then a prefill of GEMMA_CUT tokens and 4 teacher-forced decode
    steps held against the first prefill's logits."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    cfg = get_config("gemma2-9b")
    B, P = GEMMA_BATCH, GEMMA_PROMPT
    kv_bytes = (2 * cfg.n_layers * B * (P + GEMMA_DECODE + 1) * cfg.n_kv_heads
                * cfg.resolved_head_dim * 2)
    out: dict = {"arch": cfg.name, "n_layers": cfg.n_layers,
                 "param_count": cfg.param_count(),
                 "reckoned_gb": dict(params=cfg.param_count() * 2 / 1e9,
                                     kv_cache=kv_bytes / 1e9,
                                     logits=B * P * cfg.vocab_size * 2 / 1e9)}
    log(f"gemma2 memory reckoned before the run: params "
        f"{out['reckoned_gb']['params']:.2f} GB (bf16), KV cache "
        f"{out['reckoned_gb']['kv_cache']:.2f} GB, logits "
        f"{out['reckoned_gb']['logits']:.2f} GB (bf16) plus the softcap's "
        f"temporaries")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.cast_params(M.init_params(
        cfg, torch.Generator(device=DEV).manual_seed(seed), device=DEV), cfg)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    prompts = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, P))).to(DEV)

    fa.LAUNCHES = fa.TENSOR_CORE_LAUNCHES = fa.CUDA_CORE_LAUNCHES = 0
    res = serve.generate(params, cfg, prompts, GEMMA_DECODE + 1)
    out["flash_launches"] = fa.LAUNCHES
    out["flash_tensor_core_launches"] = fa.TENSOR_CORE_LAUNCHES
    if out["flash_launches"] != cfg.n_layers or \
            fa.TENSOR_CORE_LAUNCHES != cfg.n_layers:
        raise AssertionError(f"prefill and decode made {out['flash_launches']} "
                             f"flash launches ({fa.TENSOR_CORE_LAUNCHES} on "
                             f"the tensor cores), expected {cfg.n_layers} on "
                             f"the tensor cores (one per layer of the "
                             f"prefill, none in decode)")
    logits = res.prefill_logits
    if tuple(logits.shape) != (B, P, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                             f"finite or not [B,S,V]")
    toks = res.tokens
    if tuple(toks.shape) != (B, GEMMA_DECODE + 1) or \
            int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"decoded tokens {tuple(toks.shape)} out of range")
    out.update(
        prefill_ms=res.prefill_s * 1e3,
        prefill_tokens_per_s=B * P / res.prefill_s,
        decode_ms_per_step=res.decode_s * 1e3 / res.decode_steps,
        decode_tokens_per_s=B * res.decode_steps / res.decode_s,
        decode_steps=res.decode_steps,
        logits_abs_max=float(logits.abs().max().float()),
        logits_std=float(logits[:, -64:].float().std()))
    log(f"gemma2 init {out['init_s']:.3f} s; prefill: {B} x {P} tokens in "
        f"{out['prefill_ms']:.3f} ms ({out['prefill_tokens_per_s']:.1f} tok/s), "
        f"{out['flash_launches']} flash launches "
        f"({out['flash_tensor_core_launches']} on the tensor cores); decode: "
        f"{res.decode_steps} "
        f"steps, {out['decode_ms_per_step']:.3f} ms/step "
        f"({out['decode_tokens_per_s']:.1f} tok/s); logits up to "
        f"{out['logits_abs_max']:.4f}")

    want = logits[:, GEMMA_CUT:GEMMA_CUT + 4].float().clone()
    del logits, res
    torch.cuda.empty_cache()
    # the teacher-forced run, each half in a profiled window: the device's
    # share of the prefill and of the decode steps, and where it goes
    fa.LAUNCHES = fa.TENSOR_CORE_LAUNCHES = fa.CUDA_CORE_LAUNCHES = 0
    cache = M.init_cache(cfg, B, P, device=DEV)
    (_, cache), out["prefill_profile"] = device_window(
        lambda: M.serve_step(params, cfg, {"tokens": prompts[:, :GEMMA_CUT]},
                             cache, 0))
    if fa.LAUNCHES != cfg.n_layers or fa.TENSOR_CORE_LAUNCHES != cfg.n_layers:
        raise AssertionError(f"the {GEMMA_CUT}-token prefill made "
                             f"{fa.LAUNCHES} flash launches, "
                             f"{fa.TENSOR_CORE_LAUNCHES} on the tensor cores")

    def teacher_forced():
        steps = []
        for j in range(4):
            step, _ = M.serve_step(
                params, cfg,
                {"tokens": prompts[:, GEMMA_CUT + j:GEMMA_CUT + j + 1]},
                cache, GEMMA_CUT + j)
            steps.append(step[:, 0].float())
        return steps
    steps, out["decode_profile"] = device_window(teacher_forced)
    diffs = [float((s - want[:, j]).abs().max()) for j, s in enumerate(steps)]
    out["teacher_forced_max_abs_diff"] = max(diffs)
    for name in ("prefill", "decode"):
        w = out[f"{name}_profile"]
        log(f"gemma2 {name} under the profiler: wall {w['wall_ms']:.3f} ms, "
            f"device {w['device_ms']:.3f} ms (busy {w['busy_share']:.4f}); "
            f"top: " + "; ".join(f"{k['name'][:48]} {k['ms']:.3f} ms x"
                                 f"{k['count']}" for k in w["top_kernels"]))
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"gemma2 teacher-forced decode at {GEMMA_CUT}..{GEMMA_CUT + 3} (window "
        f"{cfg.sliding_window} active): max abs diff {max(diffs):.4e} against "
        f"the prefill logits (tolerance {GEMMA_TEACHER_TOL}); peak device "
        f"memory {out['peak_memory_gb']:.3f} GB")
    if not max(diffs) <= GEMMA_TEACHER_TOL:
        raise AssertionError(f"gemma2 teacher-forced decode diverges: {diffs}")
    del params, cache, prompts
    torch.cuda.empty_cache()
    return out


def attention_dominated(params, mul: float):
    """The params with every layer's wq scaled by ``mul``: at init the
    scores q·k/16 are about N(0, 1), so the softcap of 50 barely acts;
    scaled by 20 they reach it."""
    from repro_torch.tree import tree_map

    out = tree_map(lambda t: t, params)
    for block in out["blocks"].values():
        block["attn"]["wq"] = block["attn"]["wq"] * mul
    return out


# planted faults of the attention: the same params run on the CPU by a
# config that lacks one of its options
GEMMA_FAULTS = {"window dropped": dict(sliding_window=None),
                "softcap dropped": dict(attn_logit_softcap=None),
                "causality dropped": dict(causal=False)}


def gemma2_card_vs_cpu_phase(seed: int) -> dict:
    """gemma2-9b at full width cut to one block (2 layers: local, global),
    fp32 compute: one 512-token prefill on the card (kernel) and on the CPU
    (plain), logits within 2e-3 (tests/test_arch_smoke.py's decode
    tolerance), the same next greedy token.  Twice: on the params at init,
    where at 512 tokens the 4096-token window masks nothing and the scores
    stay far below the softcap; and with the window cut to 128 tokens and
    wq scaled by 20, where both act.  Each planted fault (GEMMA_FAULTS) is
    run on the CPU and its distance from the plain logits reported; in the
    second variant every one of them must exceed the tolerance, so that
    the check can see a kernel that drops the window, the softcap or the
    causal mask."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map

    base_cfg = replace(get_config("gemma2-9b"), n_layers=2,
                       compute_dtype="float32")
    params = M.cast_params(M.init_params(
        base_cfg, torch.Generator(device=DEV).manual_seed(seed + 3),
        device=DEV), base_cfg)
    host_init = tree_map(lambda t: t.cpu(), params)
    del params
    toks = torch.from_numpy(np.random.default_rng(seed + 9).integers(
        0, base_cfg.vocab_size, (1, 512)))
    out = {}
    for name, cfg, host, must_see in (
            ("init", base_cfg, host_init, False),
            ("window 128, wq x20", replace(base_cfg, sliding_window=128),
             attention_dominated(host_init, 20.0), True)):
        card_params = tree_map(lambda t: t.to(DEV), host)
        before = fa.LAUNCHES
        card, _ = M.serve_step(card_params, cfg, {"tokens": toks.to(DEV)},
                               None, None)
        card = card.cpu()
        del card_params
        torch.cuda.empty_cache()
        if fa.LAUNCHES - before != cfg.n_layers:
            raise AssertionError("the card's prefill did not go through the "
                                 "kernel")
        t0 = time.perf_counter()
        plain, _ = M.serve_step(host, cfg, {"tokens": toks}, None, None)
        cpu_s = time.perf_counter() - t0
        faults = {}
        for fault, change in GEMMA_FAULTS.items():
            wrong, _ = M.serve_step(host, replace(cfg, **change),
                                    {"tokens": toks}, None, None)
            faults[fault] = float((wrong - plain).abs().max())
        if fa.LAUNCHES - before != cfg.n_layers:
            raise AssertionError("the CPU prefill launched the kernel")
        diff = float((card - plain).abs().max())
        same = bool(torch.equal(card[:, -1].argmax(-1),
                                plain[:, -1].argmax(-1)))
        agree = float((card.argmax(-1) == plain.argmax(-1)).float().mean())
        log(f"gemma2 card vs cpu (fp32, 2 layers, 1 x 512, {name}): max abs "
            f"logit diff {diff:.3e} (tolerance 2e-3; logits up to "
            f"{float(plain.abs().max()):.4f}), next greedy token equal: "
            f"{same}, greedy tokens equal at {agree:.4f} of positions; CPU "
            f"prefill {cpu_s:.3f} s; planted faults move the plain logits "
            f"by " + ", ".join(f"{f} {d:.3e}" for f, d in faults.items()))
        if not (torch.allclose(card, plain, atol=2e-3, rtol=2e-3) and same):
            raise AssertionError(f"gemma2 ({name}): card and CPU disagree")
        if must_see and not all(d > 2e-3 for d in faults.values()):
            raise AssertionError(f"gemma2 ({name}): a planted fault stays "
                                 f"within the tolerance: {faults}")
        out[name] = dict(max_abs_diff=diff, next_token_equal=same,
                         greedy_agreement=agree, cpu_prefill_s=cpu_s,
                         planted_fault_max_abs_diff=faults)
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
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan

    # fp32 on the card in full fp32: no TF32 in matmuls or convolutions;
    # bf16 products summed in fp32, as the JAX package's reference does
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    t0 = time.perf_counter()
    sources = [checksum.SOURCE, ssd_scan.SOURCE, ssd_scan.TC_SOURCE,
               flash_attention.SOURCE]
    with ThreadPoolExecutor(len(sources)) as pool:   # one nvcc per source
        list(pool.map(nvcc.build, sources))         # re-raises a failure
    build_s = time.perf_counter() - t0
    log(card)                    # nvidia-smi's "name, power.limit" line
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    log(f"kernel build (nvcc, sm_90a, {len(sources)} sources in parallel): "
        f"{build_s:.3f} s")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    base = np.random.default_rng(args.seed).integers(
        0, 256, 1 << 22, dtype=np.uint8).tobytes()
    extent = (REC_HDR_SIZE + RECORD_BYTES + 7) & ~7
    main_rows = RING_BYTES // extent
    kern = kernel_phase(gen, main_rows)
    main, rs = main_path_phase(base)
    try:
        if main["acked"] != main_rows:
            raise AssertionError(f"ring held {main['acked']} records, "
                                 f"expected {main_rows}")
        t0 = time.perf_counter()
        health = health_phase(rs, main["acked"], main["digest"], args.seed)
        log(f"phase health: {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        resync = trim_resync_phase(rs, base, main["acked"])
        log(f"phase trim+resync: {time.perf_counter() - t0:.3f} s")
    finally:
        rs.shutdown()
    del rs
    t0 = time.perf_counter()
    router = router_kv_phase(base)
    log(f"phase router+kv: {time.perf_counter() - t0:.3f} s")
    default_config_phase(base)
    strict_crash_phase(base)
    ssd = ssd_kernel_phase(args.seed)
    serving = serving_phase(args.seed)
    cross = card_vs_cpu_phase(serving.pop("restored"), args.seed)
    torch.cuda.empty_cache()
    flash = flash_kernel_phase(args.seed)
    flash_attrs = flash_attributes()
    for a in flash_attrs:
        log(f"flash kernel {a['dtype']} D={a['head_dim']}"
            f"{' softcap' if a['softcap'] else ''} ({a['route']}): "
            f"{a['registers']} registers, {a['local_bytes']} local bytes, "
            f"{a['shared_bytes']} shared bytes, {a['threads']} threads")
    gemma = gemma2_serving_phase(args.seed)
    gemma_cpu = gemma2_card_vs_cpu_phase(args.seed)

    at = kern[f"batch({main_rows},259) 1GiB ring"]
    new_paths = [health["scrub_launches"], health["second_pass_launches"],
                 health["replay_launches"], resync["gap_launches"],
                 resync["rebuild_launches"], router["fill_launches"],
                 router["recover_launches"]]
    main_launches = (main["fill_launches"] + main["recovery_launches"]
                     + main["rebuild_launches"]
                     + sum(c["launches"] for c in new_paths))
    short = (main["fill_short_row_launches"]
             + main["recovery_short_row_launches"]
             + main["rebuild_short_row_launches"]
             + sum(c["short_rows"] for c in new_paths))
    kernels = [dict(
        name="checksum_rows", route="cuda",
        source="src/repro_torch/csrc/checksum.cu",
        replaces="src/repro/kernels/checksum/checksum.py:30",
        launches=main_launches,
        launches_by_route={"short_rows": short,
                           "long_rows": main_launches - short},
        max_abs_err=max(r["max_abs_err"] for r in kern.values()
                        if "max_abs_err" in r),
        ms=at["kernel_alone_ms"], wrapper_ms=at["ms"],
        plain_ms=at["plain_ms"], bound_ms=at["bound_ms"],
        bound_by=at["bound_by"], library_ms=None)]
    serve_at = ssd[f"ssd{SSD_SERVE} bfloat16 mixer views"]
    turns = serve_at["layouts"]
    kernels.append(dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/csrc/ssd_scan_tc.cu",
        cuda_core_source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/ssd_scan.py:29",
        launches=serving["ssd_launches"],
        launches_by_route={
            "tensor_cores": serving["ssd_tensor_core_launches"],
            "cuda_cores": (serving["ssd_launches"]
                           - serving["ssd_tensor_core_launches"])},
        max_abs_err=max(r["max_abs_err"] for r in ssd.values()),
        ms=float(np.median(turns["mixer views"]["alone_ms"])),
        wrapper_ms=serve_at["ms"],
        contiguous_ms=float(np.median(turns["contiguous"]["alone_ms"])),
        plain_ms=serve_at["plain_ms"],
        bound_ms=serve_at["bound_ms"], bound_by=serve_at["bound_by"],
        library_ms=None))
    flash_at = flash["gemma2 global (2, 16, 8, 8192, 256) bfloat16"]
    kernels.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:35",
        launches=gemma["flash_launches"],
        launches_by_route={
            "tensor_cores": gemma["flash_tensor_core_launches"],
            "cuda_cores": (gemma["flash_launches"]
                           - gemma["flash_tensor_core_launches"])},
        max_abs_err=max(r["max_abs_err"] for r in flash.values()),
        ms=flash_at["ms"], plain_ms=flash_at["plain_ms"],
        bound_ms=flash_at["bound_ms"], bound_by=flash_at["bound_by"],
        library_ms=flash_at["library_ms"]))
    print(json.dumps({"shapes": kern, "main_path": main, "health": health,
                      "trim_resync": resync, "router_kv": router,
                      "ssd_shapes": ssd,
                      "serving": serving, "card_vs_cpu": cross,
                      "flash_shapes": flash, "gemma2_serving": gemma,
                      "gemma2_card_vs_cpu": gemma_cpu}))
    print(json.dumps({"flash_kernel_attributes": flash_attrs}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
