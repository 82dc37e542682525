#!/usr/bin/env python3
"""Run the PyTorch port of the Arcadia log on one NVIDIA card.

    python3 chip_smoke.py [--seed N]
        [--phase ssd|ssd_backward|flash|flash_backward|causal_conv|
                 distributed|whole_models|faults]

Builds the CUDA kernels of the lane-polynomial integrity hash, of the
Mamba2 SSD chunked scan (tensor-core and CUDA-core sources) and its
backward (the same two routes), and of flash attention and its backward
from ``src/repro_torch/csrc``
(one nvcc per source, in parallel) and then, on the card:

  kernel        the hash against its plain PyTorch version, bit-exact, at
                every listed shape, each on the route its row length picks
                (one warp a row up to 4096 lanes, block chunks and atomics
                above), with the wrapper's median time, its time alone
                (launches replayed from a CUDA graph; on the long-row
                route also the kernel without its memset and cast), the
                plain version's time and the HBM bound, also at qwen2-7b's
                7.60 GB wi grad as one row; and the log's per-wave hash of
                a pinned (64, 259) matrix by host clock, with the device
                operations it issues;
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
  faults        the log's fault paths on fig7's 16 MiB ring of 1 KiB
                records, every payload hashed by the kernel: Table 1 —
                Arcadia against power loss (a strict device crashed with
                keep probability 0.3), a partition within the quorum, bit
                rot in 64 of the primary's payloads and the primary's
                device lost, every acked record back byte-exact in each,
                and PMDK, FLEX and QueryFresh against the same four, each
                showing exactly Table 1's failure mode; 16 seeds of the
                chaos soak's schedule generator (a partition in degraded
                quorum, a mid-wire kill with a pipelined round in flight
                and salvage, seeded rot on any copy, a rejoin with resync,
                a scrub that must find and repair exactly the rot still
                present, converged copies), each run also on the CPU with
                the same digest and durable image; the adaptive depth at
                W = 2 of 3, ceiling 8, over a 4 ms wire, which must reach
                the ceiling and halve when both backups die under two
                rounds, then salvage every record.  No CUDA tensor may
                reach the plain hash; every launch is counted.  ``--phase
                faults`` runs it alone and prints its JSON;
  ssd kernel    the SSD kernels against their plain version at every
                listed shape (fp32 within 1e-4, bf16 within 5e-2 and, per
                (batch, head, chunk) block of y, within 2^-6 of the
                block's largest value), each case on the route the table
                names (bf16 at widths that are multiples of 16 and chunks
                of 64·k on the tensor cores, also as the mixer's strided
                views; fp32, and bf16 at a chunk of 16 and at S = 100, on
                the "cuda_cores" route, whose three launches also
                run on the tensor cores: fp32 as three TF32 products, held
                to ``ref.ssd_split_reference`` too, bf16 with the
                tensor-core route's roundings), with its median time, the
                plain version's time and its bound (fp32 at three TF32
                products, with the 67 TFLOP/s fp32 figure beside it); in
                fp32 both against a float64 recurrence, where at N = 128
                the kernel may be no further from it than the plain one;
                the fp32 serving shape also alone (CUDA graph) and per
                launch (torch.profiler); at the serving shape the scan of
                the second half alone and the scan with decays twice as
                fast must fail the block check, and the mixer's views and
                contiguous copies of them are timed in turns on the same
                data: the scan alone (20 scans replayed from a CUDA
                graph), per call with the L2 flushed, the host's time to
                issue a call, and each of the three launches' device time
                (torch.profiler); then each "cuda_cores" launch's
                registers and spill bytes at each (P, dtype) of its cases
                (a spill fails).  ``--phase ssd`` runs it alone and prints
                its JSON;
  serving       mamba2-130m at full width from --seed, saved as a
                checkpoint whose manifest commits through a replicated log
                (2 backups, W = 2 of 3, phash threshold 256 B), the log
                reopened and the params restored byte-exact, then 8
                prompts of 4096 tokens prefilled (one SSD launch per
                layer, on the tensor cores) and 32 greedy decode steps
                (one conv launch per layer and step, prefill included),
                with 4 teacher-forced
                decode steps held against the prefill logits;
  card vs cpu   the restored params in fp32, one 512-token prefill on the
                card (kernels: a scan a layer on the "cuda_cores" route, a
                conv a layer in fp32) and on the CPU (plain): logits within 2e-3 and the same next
                greedy token.  The teacher-forced and
                card-vs-CPU checks run again on a variant of the params in
                which the scan carries each mixer's output (at init it is
                mostly the 4-token conv);
  ssd backward  the SSD backward kernels (the gradient through ops.ssd's
                autograd Function) against the plain chunked backward and
                torch.autograd through the plain scan, within 1e-4 (fp32) /
                5e-2 (bf16) of each gradient's largest value, each case on
                the route the table names (bf16 with chunks of 64·k on the
                tensor cores, also as the mixer's views, and held to the
                kernel's CPU mirror and a float64 gradient too; fp32, a
                chunk of 16 and a misaligned bf16 copy on the "cuda_cores"
                route — seven launches on the tensor cores, fp32 held to
                ``ref.ssd_backward_split_reference``, bf16 to the
                tensor-core route's mirror),
                at the CPU tests' shapes, at jamba's groups (G 8) over
                chunks, at the widest P and N the tensor cores take, and
                at mamba2-130m's training shape
                (8 x 4096: bf16 views, a misaligned bf16 copy, fp32), two
                calls bitwise equal, fp32 cases against a float64 gradient;
                at the training shape the gradient of each half of the
                sequence alone (no adjoint or no state across the halves)
                must fail the check; with its median time a call, alone
                (CUDA graph) and per launch (torch.profiler) at the training
                shape (the fp32 and misaligned bf16 cases too), the plain
                versions' and its bound (fp32 at three TF32 products and at
                67 TFLOP/s); then each launch's registers and spill bytes at
                each (P, N) of its cases on both routes (a spill on the
                "cuda_cores" route fails).  ``--phase ssd_backward`` builds the
                kernels, runs this phase alone and prints its JSON (not
                the run's result line);
  causal conv   the mixer's conv kernels against their plain versions
                at mamba2-130m's training shape as the mixer's views (bf16
                and fp32), a misaligned view (copied first), prefill,
                decode and two rows with a state: the forward within one
                bf16 ulp of the fp32 mirror and the new state bitwise the
                plain route's, the gradient within 2^-7 (fp32: 1e-5) of
                each gradient's largest value off fp32 autograd and
                bitwise on a second call; the pair's time alone (CUDA
                graph, L2 flushed) and a call beside the bytes bound and
                the plain version's; registers and spills (a spill fails).
                The conv's launches are counted on every mamba2-130m path
                (serving, card vs cpu, train, train cpu, the pipeline) and
                must be one a layer for each forward, remat recompute and
                gradient.  ``--phase causal_conv`` runs it alone and prints
                its JSON;
  train         mamba2-130m at full width and depth (24 layers, bf16 compute,
                fp32 master params) trained on 8 x 4096 synthetic tokens a
                step with AdamW (peak lr 3e-4): a profiled step (24 SSD
                forward launches, 24 remat recomputes, 24 backward
                launches on the tensor cores and none on "cuda_cores",
                and the conv's 48 + 24 in the trainer's run, one hash launch
                per grad leaf; ms, tokens/s, peak memory, busy share, top
                kernels), then 8 steps through the journaled, checkpointed
                trainer (checkpoint every 4, F = 4, manifests and journal
                on a replicated log with 1 backup at W = 2, checkpoints on 2
                in-memory stores at W = 2) and a second deployment that
                stops after step 4, restores and finishes: the loss finite
                and falling, the resumed steps 5-8 within rtol 1e-5 of the
                uninterrupted run, every step's integrity equal to the
                plain hash of its grads on the CPU;
  train cpu     mamba2-130m at full width cut to 2 layers, fp32: one AdamW
                step of 1 x 512 tokens on the card and on the CPU from the
                same state (the fp32 scans and backward on "cuda_cores"), loss
                within 1e-5 relative and grads, moments and params within
                1e-4 of each leaf's scale (its 2 + 2 scans and 2 gradients
                on the "cuda_cores" route), where a backward run chunk by
                chunk must move the grads past that;
  flash kernel  the flash-attention kernels against their plain version
                (within tol·(1 + |plain|), tol 2e-5 fp32 / 3e-2 bf16, and
                per output row within 1e-4 / 2^-6 of the row's largest
                value) at the shapes of tests/test_kernels.py, a window
                narrower than a tile, ragged lengths, the bf16 twins of the
                mask variants at head dims 128 and 256 and at hubert's
                (80, 80) and MLA's (192, 128) pairs, and the serving
                shapes of gemma2-9b (global and local layers, bf16 and
                fp32, and scores in the softcap's range) and qwen2-7b
                (bf16 and fp32), the bf16 ones as the layer's permuted
                views, deepseek-v3's MLA prefill (2 x 4096, 128 heads, q/k
                head dim 192, v head dim 128, v the strided half of its
                expansion; bf16 and fp32), hubert-xlarge's non-causal
                encoder (8 x 1500, 16 heads of 80; bf16 and fp32),
                llava-next-34b's prefill (2 x 4096, 56 heads over 8 of
                128) and starcoder2's (2 x 4096, 24 heads over 2) as bf16
                copies 8 bytes off 16-byte alignment; each aligned bf16
                case at a tensor-core (D, Dv) pair (64, 80, 128 and 256
                with Dv = D; 192 with Dv 128) must launch the wgmma
                kernel, every other case the mma.sync one (the
                "cuda_cores" route: fp32 as three TF32 products, held
                also to ``ref.attention_split_reference``, and bf16 that
                TMA cannot read), timed alone too (CUDA graph) with its
                registers and spills;
                a dropped window, a dropped softcap, at MLA's shape a
                dropped causal mask and v read from k_nope, at hubert's a
                causal mask, at llava's a dropped causal mask must fail
                the row check; with its median
                time, the plain version's, its
                bound and, where one PyTorch call computes the same
                function (SDPA, or compiled flex_attention at gemma2's
                shapes), that call's; then each flash kernel's registers,
                local (spill) bytes and shared bytes (a kernel that spills
                fails).  ``--phase flash`` runs it alone and prints its
                JSON;
  flash bwd     the flash backward kernels (three launches a call; the
                route ``backward_route`` picks asserted per case: the
                wgmma kernels for the aligned bf16 cases, the mma.sync
                ones ("cuda_cores") for fp32 and the misaligned copies) at
                the
                training paths' shapes — gemma2-9b's global and local
                layers (1 x 8192, the local one with scores in the
                softcap's range), starcoder2-3b (2 x 4096, 24 heads over
                2; bf16 and fp32), hubert-xlarge (8 x 1500, not causal;
                bf16 and fp32), deepseek-v3's MLA (1 x 4096, D 192, Dv
                128, v a view; bf16 and fp32) and starcoder2's as
                misaligned copies — with the forward's lse
                held to the plain log-sum-exp, each gradient row by row to
                the plain backward and, on the tensor cores, to its mirror
                (in fp32 to the split mirror,
                ``ref.attention_backward_split_reference``; 2^-6 / 1e-4
                of the row's largest value,
                no less than 2^-8 of the gradient's), two calls bitwise
                equal, four planted faults (softcap derivative, one head of
                the group, delta, window) failing at gemma2's local layer;
                a call's time alone (CUDA graph), with the L2 flushed and
                per launch, the plain backward's, its bound and the
                library's backward (SDPA, or compiled flex_attention with a
                softcap); both routes' registers and spills (a spill
                fails).  ``--phase
                flash_backward`` runs it alone and prints its JSON;
  train attn    gemma2-9b (2 layers, 1 x 8192), starcoder2-3b (30 layers, 2
                x 4096; the batch halves above 70 GB), hubert-xlarge (48
                layers, 8 x 1500 frames) and deepseek-v3 (its first dense
                layer and the MTP block, 1 x 4096) at their published
                widths, bf16 compute (gemma2 and deepseek-v3 over fp32
                master params; starcoder2 and hubert keep their bf16
                params, whose fp32 MLP bias would lift the residual stream
                to fp32), AdamW (peak lr 3e-4) with the state donated: a
                step, a profiled step (flash forward launches twice a block
                layer under remat, backward calls once a layer, all
                forward launches and backward calls on the tensor cores;
                ms, tokens/s, busy share, peak memory, top kernels), 4
                steps on one batch in which the loss must fall, every
                step's integrity equal to the plain hash of its grads, and
                one state's grads taken twice bitwise equal;
  train attn    the fp32 grads of 1 x 256 at full width on the card and
  cpu           on the CPU from the same state — gemma2-9b cut to 2
                layers with a window of 128, deepseek-v3 cut to its dense
                layer and MTP block, hubert-xlarge cut to 2 layers,
                qwen2-7b, command-r-35b and moonshot-v1-16b-a3b to 1 —
                within 1e-4 of each leaf's largest, then a donated AdamW
                step on the card; with a planted fault of the backward
                (dk, dv from one head of a group for gemma2, qwen2 and
                command-r; the causal mask dropped for deepseek and
                moonshot, added for hubert) the grads must move past that;
                qwen2-7b's step is Adafactor in pieces of 2^18 elements,
                its update from the CPU's grads held to the CPU's (params
                within 1e-4 of each leaf's largest update, moments of their
                largest), and with the RMS clip taken per piece it must
                move past that;
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
                by more than 2e-3;
  deepseek-v3   deepseek-v3-671b at its published widths cut to 4 layers
                (the 3 dense-prologue layers and 1 MoE layer; MLA with its
                latent cache, 256 routed experts + 1 shared, top-8), bf16,
                from --seed: 2 prompts of 4096 tokens prefilled (one flash
                launch a layer, on the tensor cores at D 192 / Dv 128) and
                32 greedy decode steps (absorbed MLA), the prefill run
                again and required bitwise equal, then a prefill of 512
                tokens and 4 teacher-forced decode steps held against a
                516-token prefill in a copy of the config that drops no
                token (capacity factor 32), the router's inputs within the
                same relative tolerance and a token the decode routes to
                other experts (a near tie) prefilled again with the
                decode's experts, with the latent cache's bytes
                beside the per-head K/V it replaces and the peak device
                memory; then its MoE layer's ``moe_ffn`` on 256 tokens at
                the served capacity factor 1.25 (pairs dropped) on the
                card and on the CPU, each token's output within 2^-5 of
                its largest value, where dropping nothing must move it
                past that;
  deepseek cpu  deepseek-v3 at full width cut to one dense layer, fp32: a
                512-token prefill and one absorbed decode step on the card
                and on the CPU, logits within 2e-3 and the same next
                greedy token; a dropped causal mask and v read from k_nope
                must each move the logits by more than 2e-3;
  hubert        hubert-xlarge at full width and depth (48 layers, bf16):
                one forward of 8 x 1500 frame embeddings (48 flash
                launches, tensor cores, D 80, non-causal); cut to 2 layers
                in fp32, 256 frames on the card and on the CPU within
                2e-3, where a causal mask must move the logits past that;
  llava         llava-next-34b at full width cut to 2 of its 60 layers,
                bf16: 2 prompts of 2880 patch embeddings + 1216 tokens
                prefilled (2 flash launches, tensor cores) and 8 decode
                steps; finite logits, and other patches must move the
                token positions' logits by more than 0.05;
  distributed   the distributed layer over a one-rank NCCL group (no byte
                crosses a link): one MoE layer of moonshot-v1-16b-a3b at
                its published width (64 experts, top-6, 8 x 4096 tokens,
                a 1 GB dispatch buffer) through expert parallelism and
                NCCL's all-to-all, forward and backward, bitwise the dense
                path's y and aux, its grads within 2^-7 of each leaf's
                largest (bitwise reported); the int8 compressed all-reduce
                of that layer's wi gradient in fp32 (369 M values), bitwise
                the plain quantize-dequantize and within 0.02 of exact; a
                one-stage pipeline of mamba2-130m's 24 blocks, 4
                microbatches of 2 x 4096, bitwise the stack run on each in
                turn, with 96 SSD scans on the tensor cores (set to 0 just
                before and read just after).  ``--phase distributed`` runs
                it alone and prints its JSON;
  whole models  the configs one card holds, at their published widths and
                depths, bf16, one after another: qwen2-7b (2 x 8192),
                command-r-35b (1 x 8192), moonshot-v1-16b-a3b (2 x 4096)
                and llava-next-34b (1 x 4096 with its 2880 patches) through
                launch/serve.generate with 32 decode steps; init's peak at
                most the param bytes + one block's fp32 slice + 1 GiB, a
                flash launch a layer on the tensor cores, finite logits;
                the dense three's 4 teacher-forced steps: each layer fed
                the prefill's input, its output, its attention's output
                and the K/V it caches held to the prefill's (a rotary
                position off by one and a cache write one slot early,
                planted, must fail), the decode no further from an fp32
                forward than 1.5 times the bf16 prefill is, and qwen2-7b's
                within 3% of the prefill's largest logit; moonshot's 4
                teacher-forced steps to a 516-token prefill routed alike,
                within 3%; the card's allocated
                bytes back at their start after each; then qwen2-7b trained
                whole through launch/train.py's main (Adafactor, 1 x 4096,
                5 journaled steps): finite losses, every journal record
                durable, each step's integrity equal to the plain hash of
                its grads, the hash reading each grad in place, the flash
                forward, backward and hash launches counted, the peak under
                the card's memory; then the checkpointing trainer on the
                same run: the step-3 checkpoint of the whole 23.17 GB state
                by save_async behind step 3 to two FileStore replicas (a
                chunk a stacked layer) with the manifest in a replicated
                log, a crash after step 3 (the log's devices as their media
                holds them), one byte of the largest shard flipped on
                replica 0, the log rebuilt by quorum recovery and a fresh
                trainer restoring step 3 (every leaf's plain hash the
                saved one's, replica 0 read-repaired), re-seating the data
                from the journal and running steps 3 and 4 (losses within
                1e-5, every final leaf's hash the 5-step run's); the stall,
                save and restore times, host memory and disk reported.
                ``--phase whole_models`` runs it alone and prints its JSON.

Each model path prints its configuration, a ``reduced`` list of every cut
from the published config, the card's name and power limit, and its peak
device memory; the flash kernel's launches are counted per path (set to 0
just before each path runs and read just after).

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
import math
import os
import re
import struct
import subprocess
import sys
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# compiled flex_attention, timed beside the flash kernel, keeps its build
# inside the checkout and compiles in this process (no worker pool)
os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                      str(ROOT / "src" / "repro_torch" / "_build" / "inductor"))
os.environ.setdefault("TRITON_CACHE_DIR",
                      str(ROOT / "src" / "repro_torch" / "_build" / "triton"))
os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")
# the distributed phase's one-rank NCCL group never leaves this host
os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM CUDA-core rate, the closest
                               # published peak to the kernel's 32-bit
                               # integer multiply-adds (2 ops each), and
                               # the peak for fp32 products
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core rate
TF32_OPS_PER_S = 495e12        # H100 SXM dense TF32 tensor-core rate (NVIDIA
                               # data sheet); an fp32-accurate product is
                               # three TF32 products (hi·hi + hi·lo +
                               # lo·hi), so fp32 attention's floor is
                               # 3·ops at this rate
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
        alone, only = hash_alone_ms(mat, 100)
        plain = timed_ms(lambda: ref.checksum_lanes_2d(mat), 5 if big else 20,
                         flush)
        b, by = bound_ms(rows, lanes)
        results[name] = dict(shape=[rows, lanes], route=route, max_abs_err=err,
                             ms=ms, kernel_alone_ms=alone,
                             long_row_kernel_ms=only, plain_ms=plain,
                             bound_ms=b, bound_by=by)
        only_txt = "" if only is None else \
            f" (the kernel without its memset and cast {only:.6f} ms)"
        log(f"kernel {name} ({route}): exact, kernel alone {alone:.6f} ms"
            f"{only_txt}, wrapper {ms:.6f} ms, plain {plain:.6f} ms, bound "
            f"{b:.6f} ms ({by})")
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
        alone, only = hash_alone_ms(ref.as_words(x).view(1, -1), 20)
        plain = timed_ms(lambda: ref.tensor_checksum(x), 5, flush)
        b, by = bound_ms(1, lanes)
        results[name] = dict(shape=list(x.shape), max_abs_err=err, ms=ms,
                             kernel_alone_ms=alone, long_row_kernel_ms=only,
                             plain_ms=plain, bound_ms=b, bound_by=by)
        log(f"kernel {name}: exact, kernel alone {alone:.6f} ms (without its "
            f"memset and cast {only:.6f} ms), wrapper {ms:.6f} ms, plain "
            f"{plain:.6f} ms, bound {b:.6f} ms ({by})")
        del x
    results["qwen2-7b wi grad"] = widest_grad_hash(gen, flush)
    torch.cuda.empty_cache()
    return results


def long_row_kernel(mat: torch.Tensor, out: torch.Tensor) -> None:
    """The long-row kernel by itself on ``mat``, adding into ``out`` (int32
    [rows]) on the current stream: no memset, no cast, and no count (a
    timing's launch)."""
    from repro_torch.kernels.checksum import checksum

    rows, lanes = mat.shape
    err = checksum._fn("arcadia_checksum_rows")(
        mat.data_ptr(), out.data_ptr(), rows, lanes,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"long-row kernel launch failed: cudaError_t {err}")


def hash_alone_ms(mat: torch.Tensor, launches: int):
    """(the hash wrapper's device time alone, the long-row kernel's by
    itself or None on the short-row route): ``launches`` calls replayed
    from a CUDA graph (``kernel_alone_ms``).  On the long-row route the
    wrapper is a memset, the kernel and a cast."""
    from repro_torch.kernels.checksum import checksum

    alone = kernel_alone_ms(lambda: checksum.checksum_rows_cuda(mat),
                            launches)
    if checksum.route(mat.shape[1]) == "short_rows":
        return alone, None
    out = torch.zeros(mat.shape[0], dtype=torch.int32, device=mat.device)
    return alone, kernel_alone_ms(lambda: long_row_kernel(mat, out), launches)


def widest_grad_hash(gen: torch.Generator, flush: torch.Tensor) -> dict:
    """The hash of qwen2-7b's largest grad leaf (the stacked wi, bf16) as
    the journaled step hashes it, one row of all its lanes, on the
    long-row kernel: exact against the plain hash in pieces
    (``plain_hash``), timed alone and by itself (5 launches), by wrapper
    and against its bound."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.checksum import ops, ref
    from repro_torch.models import model as M
    from repro_torch.tree import leaf_paths

    path, spec = max(leaf_paths(M.param_specs(get_config("qwen2-7b"))),
                     key=lambda kv: math.prod(kv[1].shape))
    x = torch.empty(spec.shape, dtype=spec.dtype, device=DEV)
    x.view(torch.int16).random_(-2 ** 15, 2 ** 15, generator=gen)
    words = ref.as_words(x).view(1, -1)
    lanes = words.shape[1]
    err = abs(int(ops.tensor_checksum(x)) - plain_hash(x))
    if err:
        raise AssertionError(f"qwen2-7b {path} grad: kernel differs from the "
                             f"plain hash")
    ms = timed_ms(lambda: ops.tensor_checksum(x), 5, flush)
    alone, only = hash_alone_ms(words, 5)
    b, by = bound_ms(1, lanes)
    log(f"kernel qwen2-7b {path} grad {list(spec.shape)} {spec.dtype} as one "
        f"row of {lanes} lanes ({-(-lanes // 4096)} blocks into one word): "
        f"exact, kernel alone {alone:.6f} ms (without its memset and cast "
        f"{only:.6f} ms), wrapper {ms:.6f} ms, bound {b:.6f} ms ({by})")
    del x, words
    return dict(leaf=path, shape=list(spec.shape), lanes=lanes, max_abs_err=err,
                ms=ms, kernel_alone_ms=alone, long_row_kernel_ms=only,
                bound_ms=b, bound_by=by)


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
    l0 = checksum.LAUNCHES
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
    fill = checksum.LAUNCHES - l0
    survivor = dev.crash(np.random.default_rng(0), keep_probability=0.3)
    l0 = checksum.LAUNCHES
    got = dict(Log.open(survivor, LogConfig(capacity=FIG7_RING_BYTES))
               .iter_records())
    rec_launches = checksum.LAUNCHES - l0
    lost = [l for l in written if l <= durable and got.get(l) != written[l]]
    bad = [l for l, p in got.items() if written.get(l) != p]
    log(f"strict crash: {len(written)} records written, durable-acked up to "
        f"lsn {durable}, {len(got)} recovered, {fill} + {rec_launches} launches")
    if lost or bad or sorted(got) != list(range(1, len(got) + 1)):
        raise AssertionError(f"strict crash lost {lost[:5]} / corrupt {bad[:5]}")
    if fill == 0 or rec_launches == 0:
        raise AssertionError("strict crash phase did not go through the kernel")
    return dict(written=len(written), durable=durable, recovered=len(got))


# ------------------------------- faults ------------------------------- #
# Table 1 of the paper and the reference's fault schedules on the card:
# every payload is a 1 KiB record on fig7's 16 MiB ring, hashed by the
# kernel (phash threshold 256 B).  tests/test_torch_resilience.py,
# test_torch_chaos.py and test_torch_salvage_adaptive.py hold the same
# scenarios to the JAX package on the CPU.

FAULT_RECORDS = 16000          # a baseline's fill: 16,000 x 1 KiB in 16 MiB
FAULT_ROT = 64                 # payloads rotted in the media-error cells
CHAOS_SEEDS = 16
FAULT_WIRE_S = 0.004           # the adaptive run's injected wire (fig6)
FAULT_CEILING = 8


def wait_for(cond, what: str, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.001)


def hold_until_fenced(transport) -> None:
    """Hold each later write of ``transport``'s lane until its backup
    fences the primary (the write then fails on the wire): a round in
    flight to a backup that dies under it."""
    real = transport.write_imm_staged
    released = threading.Event()

    def write(staged):
        if not released.is_set():
            wait_for(lambda: transport.server.is_fenced(transport.primary_id),
                     "the backup's fence")
            released.set()
        return real(staged)
    transport.write_imm_staged = write


def lane_acked_all(wal, transport) -> bool:
    for e in list(wal._inflight):
        rnd = getattr(getattr(e, "handle", None), "round", None)
        if rnd is None or transport not in [t for t, _ in
                                            rnd.salvage().acked]:
            return False
    return True


def hashed_set(capacity: int, device=None, **kw):
    """build_replica_set's local primary + 2 backups at W = 2 of 3 (unless
    ``kw`` says otherwise), hashing every record of PHASH_THRESHOLD bytes
    or more on ``device``."""
    from repro_torch.core import build_replica_set
    kw.setdefault("write_quorum", 2)
    rs = build_replica_set(mode="local+remote", capacity=capacity,
                           n_backups=2, device=device or DEV, **kw)
    rs.cfg.phash_threshold = PHASH_THRESHOLD
    return rs


def records_of(dev, capacity: int) -> dict:
    from repro_torch.core import Log, LogConfig
    return {lsn: bytes(p) for lsn, p in Log.open(
        dev, LogConfig(capacity=capacity), device=DEV).iter_records()}


def fill_acked(wal, base: bytes, n: int, start: int = 0) -> dict:
    """Append ``n`` 1 KiB records in forced waves -> {lsn: payload}."""
    acked = {}
    for w in range(start, start + n, WAVE):
        wave = [payload(i, base) for i in range(w, min(w + WAVE, start + n))]
        acked.update(zip(wal.append_batch(wave), wave))
    return acked


def arcadia_cells(base: bytes, seed: int) -> dict:
    """Arcadia against Table 1's four failures, every acked record back
    byte-exact in each: power loss (the strict crash phase), a partition
    within the quorum, bit rot in FAULT_ROT payloads of the primary
    (quorum recovery picks a clean copy), the primary's device lost
    (quorum recovery from the two backups)."""
    from repro_torch.core import CopyAccessor, quorum_recover
    cap = FIG7_RING_BYTES
    n = cap // ((24 + RECORD_BYTES + 7) & ~7) - 8
    out = {"power_loss": strict_crash_phase(base)}
    rs = hashed_set(cap)
    try:
        acked = fill_acked(rs.log, base, n // 2)
        rs.fail_backup("node2")              # cut off; W = 2 still met
        acked.update(fill_acked(rs.log, base, n - n // 2, start=n // 2))
        rs.group.drain()
        if rs.log.durable_lsn != n or records_of(rs.primary_dev, cap) \
                != acked:
            raise AssertionError("partition: acked records not durable")
        out["partition"] = dict(records=n, durable=rs.log.durable_lsn)
    finally:
        rs.shutdown()
    rs = hashed_set(cap)
    try:
        acked = fill_acked(rs.log, base, n)
        rs.group.drain()
        rng = np.random.default_rng(seed)
        rotted = sorted(rng.choice(np.arange(1, n + 1), FAULT_ROT,
                                   replace=False).tolist())
        for lsn in rotted:
            rec = rs.log._recs[lsn]
            rs.primary_dev.corrupt(rec.off + 24, rec.size, rng, nbits=8)
        for cell, devs, local in (
                ("media_error", rs.server_devices(), rs.primary_id),
                ("device_failure", {s.server_id: s.device
                                    for s in rs.servers}, "node0-new")):
            accs = [CopyAccessor.for_device(k, d) for k, d in devs.items()]
            img, rep = quorum_recover(accs, rs.cfg, write_quorum=2,
                                      local_name=local)
            got = records_of(img, cap)
            if rep.chosen == rs.primary_id or got != acked:
                raise AssertionError(f"{cell}: acked records not recovered "
                                     f"(chose {rep.chosen})")
            out[cell] = dict(records=len(got), chosen=rep.chosen,
                             repair_bytes=rep.repair_bytes)
    finally:
        rs.shutdown()
    out["power_loss"]["verdict"] = "survives"
    for cell in ("partition", "media_error", "device_failure"):
        out[cell]["verdict"] = "survives"
    return out


BASELINE_VERDICTS = {
    # Table 1 (tests/test_resilience_matrix.py's docstring)
    "pmdk": dict(power_loss="survives", media_error="silent_corruption",
                 device_failure="no_copy", partition="no_copy"),
    "flex": dict(power_loss="survives", media_error="detected_not_repaired",
                 device_failure="no_copy", partition="no_copy"),
    "query_fresh": dict(power_loss="survives",
                        media_error="silent_corruption",
                        device_failure="survives", partition="survives"),
}


def baseline_cells(base: bytes, seed: int) -> dict:
    """The three baselines (host code, no hash) against the same failures
    at the same record size: each must show exactly the failure mode of
    Table 1."""
    from repro_torch.core import PMEMDevice
    from repro_torch.core.baselines import FlexLog, PMDKLog, QueryFreshLog
    from repro_torch.core.transport import (ReplicaServer, ReplicationGroup,
                                            Transport)
    cap = FIG7_RING_BYTES
    recs = [payload(i, base) for i in range(FAULT_RECORDS)]
    classes = dict(pmdk=PMDKLog, flex=FlexLog, query_fresh=QueryFreshLog)

    def fill(name, dev, **kw):
        blog = classes[name](dev, cap, **kw)
        for r in recs:
            blog.append(r)
        if name == "query_fresh":
            blog.flush()
        return blog

    def got(blog):
        return [bytes(p) for _, p in blog.iter_records()]

    out = {}
    for name, cls in classes.items():
        cells = {}
        dev = PMEMDevice(cap + 64, mode="strict")
        fill(name, dev)
        survivor = dev.crash(np.random.default_rng(seed), keep_probability=0.3)
        cells["power_loss"] = "survives" if got(cls.open(survivor, cap)) \
            == recs else "lost"
        dev = PMEMDevice(cap + 64)
        blog = fill(name, dev)
        rng = np.random.default_rng(seed + 1)
        # the first payload byte of FAULT_ROT records, from each log's own
        # layout: a record is its header then its payload, back to back
        sizes = {"pmdk": 8, "flex": 16, "query_fresh": 12}[name]
        for i in sorted(rng.choice(FAULT_RECORDS, FAULT_ROT,
                                   replace=False).tolist()):
            off = blog.HEADER + i * (sizes + RECORD_BYTES) + sizes
            dev.corrupt(off, RECORD_BYTES, rng, nbits=8)
        read = got(blog)
        cells["media_error"] = (
            "survives" if read == recs else
            "silent_corruption" if len(read) == len(recs) else
            "detected_not_repaired")
        if name == "query_fresh":
            # shipped to two backups at W = 2, one of them cut off: the
            # primary's device is lost and the other backup serves
            backups = [ReplicaServer(PMEMDevice(cap + 64), f"qf-backup{i}")
                       for i in range(2)]
            lanes = [Transport(b, "qf-primary") for b in backups]
            group = ReplicationGroup(lanes, write_quorum=2,
                                     local_is_durable=True)
            lanes[0].inject(drop=True)
            try:
                fill(name, PMEMDevice(cap + 64), repl=group)
            finally:
                group.shutdown()
            ok = got(cls.open(backups[1].device, cap)) == recs
            cells["device_failure"] = cells["partition"] = \
                "survives" if ok else "lost"
        else:
            # one copy by design: a lost or cut-off device leaves none
            cells["device_failure"] = cells["partition"] = "no_copy"
        if cells != BASELINE_VERDICTS[name]:
            raise AssertionError(f"{name}: {cells} != Table 1's "
                                 f"{BASELINE_VERDICTS[name]}")
        out[name] = cells
    return out


def chaos_payload(lsn: int) -> bytes:
    return np.random.default_rng(lsn).integers(
        0, 256, RECORD_BYTES, dtype=np.uint8).tobytes()


def chaos_run(seed: int, device: str) -> dict:
    """tests/test_chaos_soak.py's schedule generator and invariants with
    1 KiB records on the 16 MiB ring: a partition in degraded quorum, a
    mid-wire kill with a pipelined round in flight (held on the victim's
    lane until the fence, salvaged on the survivor) or no fault; seeded
    bit rot on any copy; a rejoin with online resync; more traffic; a
    scrub to clean that must find exactly the rot still present.  -> the
    digest of the records and the primary's durable image's CRC."""
    import random
    from repro_torch.core import ClusterManager, Node, Scrubber
    from repro_torch.core.log import (FLAG_VALID, _REC_HDR,
                                       _first_bad_payload, ring_offset)
    rng = random.Random(seed)
    np_rng = np.random.default_rng(seed)
    fault = rng.choice(["none", "partition", "partition", "midwire",
                        "midwire"])
    depth = rng.choice([1, 2, 4])
    wq = 3 if fault == "partition" else 2
    victim = rng.choice(["node1", "node2"])
    vt = 0 if victim == "node1" else 1
    cap = FIG7_RING_BYTES
    rs = hashed_set(cap, device=device, write_quorum=wq,
                    device_mode="strict", pipeline_depth=depth)
    try:
        cm = ClusterManager([Node(rs.primary_id)] + [
            Node(s.server_id, server=s) for s in rs.servers])
        cm.attach_log(rs.log)
        cm.attach_group(rs.group, allow_degraded=True, min_write_quorum=2)
        acked = {}

        def put(k):
            for _ in range(k):
                lsn = rs.log.append(chaos_payload(rs.log._next_lsn))
                acked[lsn] = chaos_payload(lsn)

        put(8)
        if fault == "partition":
            rs.fail_backup(victim)
            cm.report_failure(victim)
            put(8)
        elif fault == "midwire":
            rs.group.drain()
            hold_until_fenced(rs.transports[vt])
            p = b"\x5a" * RECORD_BYTES
            rid, _ = rs.log.reserve(len(p))
            rs.log.copy(rid, p)
            rs.log.complete(rid)
            rs.log.force(rid, wait=False)
            wait_for(lambda: lane_acked_all(rs.log, rs.transports[1 - vt]),
                     "the survivor's ack")
            rs.kill_backup_midwire(victim, settle_s=0.0)
            acked[rid] = p
            put(7)
        else:
            put(8)
        rs.group.drain(surface_errors=False)
        devs = {"node0": rs.primary_dev}
        devs.update({s.server_id: s.device for s in rs.servers})
        committed = [l for l in sorted(acked) if l <= rs.log.durable_lsn]
        rng.shuffle(committed)
        injected = []
        for lsn in committed[:rng.randint(1, 3)]:
            name = rng.choice(list(devs))
            rec = rs.log._recs[lsn]
            before = devs[name].read(rec.off, rec.extent)
            devs[name].corrupt(rec.off + 24, rec.size, np_rng, nbits=8)
            if devs[name].read(rec.off, rec.extent) != before:
                injected.append((name, lsn))
        if fault != "none":
            rs.transports[vt].inject()
            rs.recover_backup(victim)
            if fault == "partition":
                cm.report_recovery(victim)
        put(8)
        rs.log.drain(timeout=30.0)
        rs.group.drain(timeout=30.0)

        def clean(dev, lsn):
            rec = rs.log._recs[lsn]
            raw = dev.read(rec.off, rec.extent)
            hl, hs, hc, hf = _REC_HDR.unpack_from(raw, 0)
            if hl != lsn or hs != rec.size or not hf & FLAG_VALID:
                return False
            snap = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
            return _first_bad_payload(snap, [(0, 0, lsn, rec.size, hc, hf)],
                                      rs.log.device) is None

        still = {(n, l) for _, l in injected for n in devs
                 if not clean(devs[n], l)}
        sc = Scrubber.from_replica_set(rs)
        reports = sc.scrub_to_completion(max_passes=64)
        found = {cr for r in reports for cr in r.corrupt_records}
        st = sc.stats()
        golden = sum(r.extent for l, r in rs.log._recs.items()
                     if l <= rs.log.durable_lsn and not r.pad)
        if found != still or st["repaired"] != len(still) \
                or st["unrepairable"] or not reports[-1].complete \
                or reports[-1].corrupt \
                or not (0 < st["repair_bytes"] < golden if still
                        else st["repair_bytes"] == 0):
            raise AssertionError(f"chaos seed {seed}: scrub found {found}, "
                                 f"rot still present {still}, {st}")
        got = {l: bytes(p) for l, p in rs.log.iter_records()}
        if any(got.get(l) != p for l, p in acked.items()):
            raise AssertionError(f"chaos seed {seed}: an acked record lost")
        ring = rs.primary_dev.read(0, ring_offset() + cap)
        if any(s.device.read(0, len(ring)) != ring for s in rs.servers):
            raise AssertionError(f"chaos seed {seed}: copies diverged")
        digest = 0
        for l, p in sorted(got.items()):
            digest = zlib.crc32(p, zlib.crc32(str(l).encode(), digest))
        return dict(fault=fault, depth=depth, rot=len(injected),
                    repaired=st["repaired"], digest=digest,
                    image_crc=zlib.crc32(rs.primary_dev.to_numpy()[
                        "durable"].tobytes()))
    finally:
        rs.shutdown()


def adaptive_run(base: bytes) -> dict:
    """fig6's adaptive workload on the card deployment (W = 2 of 3,
    ceiling 8, a 4 ms injected wire, 1 KiB records with a non-blocking
    freq-4 leader, each leader's four records completed as one batch, one
    hash launch): the depth must reach the ceiling within 384 records;
    then both backups die under two held rounds (a planted round failure)
    and the depth must halve; after the rejoin the salvage makes every
    record durable and the reopened ring holds each byte-exact."""
    from repro_torch.core import CostModel, FreqPolicy
    cap = FIG7_RING_BYTES
    rs = hashed_set(cap, pipeline_depth=FAULT_CEILING, adaptive_depth=True,
                    cost=CostModel().with_wire_rtt(FAULT_WIRE_S * 1e9))
    try:
        wal = rs.log
        pol = FreqPolicy(4, wait=False)
        acked = fill_acked(wal, base, 8)
        for t in rs.transports:
            t.inject(delay_s=FAULT_WIRE_S)

        def stream(start, n):
            for w in range(start, start + n, 4):
                wave = [payload(i, base) for i in range(w, w + 4)]
                batch = wal.reserve_batch([len(p) for p in wave])
                wal.copy_batch(batch, wave)
                wal.complete_batch(batch)
                acked.update(zip(batch.lsns, wave))
                for lsn in batch.lsns:
                    pol.on_complete(wal, lsn)

        i = 8
        while wal.pipeline_depth < FAULT_CEILING and i < 8 + 384:
            stream(i, 16)
            i += 16
        pol.drain(wal)
        grown = [list(p) for p in wal.depth_trajectory]
        if wal.pipeline_depth != FAULT_CEILING:
            raise AssertionError(f"adaptive depth never reached the "
                                 f"ceiling: {grown}")
        for t in rs.transports:
            t.inject()
            hold_until_fenced(t)
        stream(i, 8)                         # two rounds, both held
        for s in rs.servers:
            s.fence(rs.primary_id)
        wait_for(lambda: wal.stats()["inflight_rounds"] == 0,
                 "the failed rounds' settle")
        failed = [list(p) for p in wal.depth_trajectory[len(grown):]]
        if not failed or failed[0][1] != FAULT_CEILING // 2:
            raise AssertionError(f"a round failure did not halve the "
                                 f"depth: {failed}")
        for s in rs.servers:
            rs.recover_backup(s.server_id)
        for _ in range(8):                   # the app retries the force
            try:
                pol.drain(wal)
                break
            except Exception:
                continue
        if wal.durable_lsn != len(acked) or records_of(
                rs.primary_dev, cap) != acked:
            raise AssertionError("adaptive: acked records not durable")
        return dict(grown=grown, after_failure=failed,
                    durable=wal.durable_lsn,
                    salvage_rounds=wal.stats()["salvage_rounds"])
    finally:
        rs.shutdown()


def plain_hash_guard():
    """Make the plain hash refuse a CUDA tensor for the phase's length
    (the wrappers route by device; this proves none reached it)."""
    from repro_torch.kernels.checksum import ref
    saved = {k: getattr(ref, k) for k in ("checksum_lanes_2d",
                                          "tensor_checksum")}

    def guard(fn):
        def call(x, *a, **k):
            if x.is_cuda:
                raise AssertionError("a CUDA tensor reached the plain hash")
            return fn(x, *a, **k)
        return call
    for k, fn in saved.items():
        setattr(ref, k, guard(fn))
    return lambda: [setattr(ref, k, fn) for k, fn in saved.items()]


def faults_phase(base: bytes, seed: int) -> dict:
    """Table 1, CHAOS_SEEDS seeded fault schedules (each also run on the
    CPU: digest and durable image equal) and the adaptive controller, on
    the card; every hash launch counted and on the kernel."""
    t0 = time.perf_counter()
    restore = plain_hash_guard()
    try:
        zero_hash_counts()
        out = dict(arcadia=arcadia_cells(base, seed),
                   baselines=baseline_cells(base, seed))
        log(f"faults table 1: arcadia {out['arcadia']}")
        log(f"faults table 1: baselines {out['baselines']}")
        card_counts = hash_counts()
        out["chaos"] = {}
        for s in range(seed, seed + CHAOS_SEEDS):
            zero_hash_counts()
            card = chaos_run(s, DEV)
            counts = hash_counts()
            plain = chaos_run(s, "cpu")
            if card != plain:
                raise AssertionError(f"chaos seed {s}: card {card} != "
                                     f"cpu {plain}")
            card["launches"] = counts["launches"]
            out["chaos"][s] = card
            for k in card_counts:
                card_counts[k] += counts[k]
        log(f"faults chaos: {CHAOS_SEEDS} schedules "
            f"{[(c['fault'], c['rot'], c['repaired']) for c in out['chaos'].values()]}"
            f", card == cpu")
        zero_hash_counts()
        out["adaptive"] = adaptive_run(base)
        counts = hash_counts()
        for k in card_counts:
            card_counts[k] += counts[k]
        log(f"faults adaptive: {out['adaptive']}")
    finally:
        restore()
    out["launches"] = card_counts
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase faults: {out['phase_s']:.3f} s, hash launches "
        f"{card_counts}")
    if card_counts["launches"] == 0 or card_counts["short_rows"] \
            + card_counts["long_rows"] != card_counts["launches"]:
        raise AssertionError(f"faults: hash launches {card_counts}")
    if any(c["launches"] == 0 for c in out["chaos"].values()):
        raise AssertionError("a chaos schedule never reached the kernel")
    return out


# ------------------------------ SSD kernel ------------------------------ #

# (B, S, H, P, G, N, chunk), dtype, layout, route: the shapes of
# tests/test_kernels.py, H=6 over G=3 groups, one short chunk at
# mamba2-130m's head widths, and the serving shape (8 prompts of 4096
# tokens) in both dtypes; the bf16 twins that the tensor-core kernel takes
# (a chunk of 64, 3 groups, mamba2's widths in two chunks), and the serving
# shape as the mixer passes it: views of one conv output (token stride
# H·P + 2·G·N).  fp32, and bf16 at other widths or chunks, take the
# "cuda_cores" route (csrc/ssd_scan.cu, on the tensor cores too).
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
    and the state update — at the peak rate for the dtype (``ops_ms``: bf16
    on the tensor cores; fp32 as three TF32 products on them)."""
    B, S, H, P, G, N, _ = shape
    el = 2 if dtype == "bfloat16" else 4
    n_bytes = (2 * B * S * H * P * el + B * S * H * 4 + H * 4
               + 2 * B * S * G * N * el + B * H * P * N * 4)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ms(ssd_ops(shape), dtype)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ssd_ops(shape, backward: bool = False) -> int:
    """The least operations of the scan (``ssd_bound_ms``) or of its
    gradient (``ssd_bwd_bound_ms``)."""
    B, S, H, P, G, N, chunk = shape
    Q = min(chunk, S)
    if backward:
        return B * (S // Q) * (H * (Q * (Q + 1) * 2 * P + 10 * Q * N * P)
                               + G * Q * (Q + 1) * 3 * N)
    return B * H * (S // Q) * (Q * (Q + 1) * (N + P) + 4 * Q * N * P)


def ssd_fp32_rate_ms(shape, backward: bool = False) -> float:
    """The scan's (or its gradient's) operations at the card's 67 TFLOP/s
    fp32 rate: the bound an fp32 kernel on the CUDA cores had, kept beside
    the three-TF32-product bound."""
    return ssd_ops(shape, backward) / FP32_OPS_PER_S * 1e3


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
    float64 recurrence and, on "cuda_cores", the split mirror; planted
    faults at the serving shape; then the "cuda_cores" launches' registers
    and spills."""
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
        mirror = None
        if route == CC and dtype == "float32":
            # the split mirror of the route's fp32 arithmetic (plain
            # PyTorch, here on the card in full fp32)
            ym, sm = ref.ssd_split_reference(*args, chunk=chunk)
            mirror = max(float((g - w).abs().max() / w.abs().max())
                         for g, w in ((y, ym), (st, sm)))
            if not mirror <= tol:
                raise AssertionError(f"{name}: kernel differs from the split "
                                     f"mirror by {mirror:.3e} of the largest "
                                     f"value (tolerance {tol})")
            del ym, sm
        big = shape[0] * shape[1] > 4096
        scan = lambda: ops.ssd(*args, chunk=chunk)  # noqa: E731
        ms = timed_ms(scan, 10 if big else 20, flush)
        alone = per_launch = None
        if big and route == CC:
            alone = kernel_alone_ms(scan, 5)
            per_launch = profiled_launch_ms(scan, r"ssd_cc_\w+(<[^>]*>)?",
                                            3)
        plain = timed_ms(lambda: ref.ssd_reference(*args, chunk=chunk),
                         3 if big else 20, flush)
        b, by = ssd_bound_ms(shape, dtype)
        b32 = ssd_fp32_rate_ms(shape) if dtype == "float32" else None
        turns = ssd_layouts(args, chunk, flush) \
            if layout == "mixer views" else None
        results[name] = dict(shape=list(shape), dtype=dtype, layout=layout,
                             route=route, max_abs_err=err, tol=tol,
                             block_rel_err=blk, block_tol=SSD_BLOCK_TOL,
                             planted_fault_block_rel_err=faults, ms=ms,
                             alone_ms=alone, launch_ms=per_launch,
                             plain_ms=plain, bound_ms=b, bound_by=by,
                             bound_fp32_rate_ms=b32,
                             mirror_rel_err=mirror,
                             err_from_float64=err64, layouts=turns)
        blk_txt = "" if blk is None else f", block err {blk:.3e} (within " \
            f"{SSD_BLOCK_TOL:.4g})"
        fault_txt = "" if faults is None else "; planted faults: " + ", ".join(
            f"{f} {e:.3e} of a block off" for f, e in faults.items())
        log(f"kernel {name} ({route}): max abs err {err:.3e} (within {tol} + "
            f"{tol}·|plain|){blk_txt}{fault_txt}"
            + ("" if mirror is None else
               f", {mirror:.3e} of the largest value from the split mirror")
            + f"; {ms:.6f} ms"
            + ("" if alone is None else f", {alone:.6f} ms alone")
            + f", plain {plain:.6f} ms, bound {b:.6f} ms ({by})"
            + ("" if b32 is None else f", {b32:.6f} ms at 67 TFLOP/s fp32"))
        if per_launch is not None:
            log(f"kernel {name} ({route}) per launch: " + ", ".join(
                f"{kn} {v:.6f} ms" for kn, v in per_launch.items()))
        for lay, t in (turns or {}).items():
            log(f"kernel {name}, in turns as {lay}: alone {t['alone_ms']} "
                f"ms, per call {t['wrapper_ms']} ms, issue {t['issue_ms']} "
                f"ms (host), launches {t['pass_ms']} ms (device) of "
                f"{t['pass_count']} recorded")
        del args, y, st, y_ref, st_ref
    info = {}
    for P, dtype in sorted({(s_[3], d_) for s_, d_, _, r in SSD_SHAPES
                            if r == CC}):
        info[f"P {P} {dtype}"] = rows = ssd_scan.kernel_info(
            P, getattr(torch, dtype))
        log(f"kernel ssd scan (cuda_cores) at P {P} {dtype}: " + ", ".join(
            f"{r['launch']} {r['registers']} registers {r['local_bytes']} "
            f"spill bytes" for r in rows))
        if any(r["local_bytes"] for r in rows):
            raise AssertionError(f"an SSD scan launch spills at P {P} "
                                 f"{dtype}: {rows}")
    results["kernel_info"] = info
    torch.cuda.empty_cache()
    return results


# ------------------------- serving mamba2-130m -------------------------- #

def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).contiguous().view(torch.uint8),
        b.reshape(-1).contiguous().view(torch.uint8))


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
    zero_conv_counts()
    res = serve.generate(served, cfg, prompts, SERVE_DECODE + 1)
    out["conv_launches"] = conv_counts()
    want_conv = dict(forward=cfg.n_layers * (1 + res.decode_steps),
                     backward=0)
    if out["conv_launches"] != want_conv:
        raise AssertionError(f"prefill and decode made conv launches "
                             f"{out['conv_launches']}, expected {want_conv}")
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
        f"({out['decode_tokens_per_s']:.1f} tok/s); conv launches "
        f"{out['conv_launches']['forward']} (one a layer and step)")

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
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map

    cfg = replace(get_config("mamba2-130m"), compute_dtype="float32")
    toks = torch.from_numpy(np.random.default_rng(seed + 7).integers(
        0, cfg.vocab_size, (1, 512)))
    out = {}
    cuda_cores = conv_launches = 0
    for name, params in (("init", restored),
                         ("scan-dominated", scan_dominated(restored))):
        zero_ssd_counts()
        zero_conv_counts()
        card, _ = M.serve_step(params, cfg, {"tokens": toks.to(DEV)}, None,
                               None)
        card = card.cpu()
        counts, conv = ssd_counts(), conv_counts()
        if counts["forward"] != cfg.n_layers or \
                counts["cuda_cores"] != cfg.n_layers or \
                conv["forward"] != cfg.n_layers:
            raise AssertionError(f"the card's fp32 prefill did not go through "
                                 f"the CUDA-core route's kernel and the conv "
                                 f"kernel: {counts}, conv {conv}")
        cuda_cores += counts["cuda_cores"]
        conv_launches += conv["forward"]
        host = tree_map(lambda t: t.cpu(), params)
        plain, _ = M.serve_step(host, cfg, {"tokens": toks}, None, None)
        if ssd_counts() != counts or conv_counts() != conv:
            raise AssertionError("the CPU prefill launched a kernel")
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
    out["ssd_cuda_core_launches"] = cuda_cores
    out["conv_launches"] = conv_launches
    return out


# ------------------------------ SSD backward ----------------------------- #

SSD_TRAIN = (8, 4096, 24, 64, 1, 128, 256)     # mamba2-130m, 8 x 4096 tokens
# Each case with the backward route it must take: the CPU tests' shapes in
# fp32 ("cuda_cores"); bf16 twins, a chunk of 64 on the tensor cores
# (contiguous and as the mixer's views) and a chunk of 16 on "cuda_cores";
# then the training shape as the mixer's bf16 views (tensor cores), as a
# bf16 copy one element off 16-byte alignment (the "cuda_cores" route on
# the same data) and in fp32 ("cuda_cores")
SSD_BWD_SHAPES = [((2, 64, 4, 32, 2, 16, 16), "float32", "contiguous", CC),
                  ((1, 128, 2, 64, 1, 32, 32), "float32", "contiguous", CC),
                  ((1, 96, 6, 16, 2, 16, 32), "float32", "contiguous", CC),
                  ((1, 64, 2, 16, 1, 64, 64), "float32", "contiguous", CC),
                  ((2, 64, 4, 32, 2, 16, 64), "bfloat16", "contiguous", TC),
                  ((1, 64, 2, 16, 1, 64, 64), "bfloat16", "mixer views", TC),
                  # jamba's groups (G 8, 2 heads each) over chunks; the
                  # widest P and N the route takes
                  ((2, 512, 16, 64, 8, 128, 256), "bfloat16", "mixer views",
                   TC),
                  ((1, 256, 4, 128, 2, 256, 128), "bfloat16", "contiguous",
                   TC),
                  ((2, 64, 4, 32, 2, 16, 16), "bfloat16", "contiguous", CC),
                  (SSD_TRAIN, "bfloat16", "mixer views", TC),
                  (SSD_TRAIN, "bfloat16", "misaligned", CC),
                  (SSD_TRAIN, "float32", "contiguous", CC)]
# of each gradient's largest magnitude: the forward's tolerances
SSD_BWD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
GRAD_NAMES = ("dxh", "ddt", "dA_log", "dBm", "dCm")


def shifted(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` one element past 16-byte alignment."""
    v = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return v.view(t.shape).copy_(t)


def ssd_bwd_inputs(shape, dtype, seed: int, layout: str):
    """``ssd_inputs`` and the cotangents: dy in xh's dtype and d(final
    state) in fp32, N(0, 1) from numpy.  Layout "misaligned": xh, Bm and Cm
    are contiguous copies one element off 16-byte alignment."""
    args = ssd_inputs(shape, dtype, seed,
                      "contiguous" if layout == "misaligned" else layout)
    if layout == "misaligned":
        xh, dt, A_log, Bm, Cm = args
        args = (shifted(xh), dt, A_log, shifted(Bm), shifted(Cm))
    B, S, H, P, G, N, _ = shape
    rng = np.random.default_rng(seed + 1000)
    dy = torch.from_numpy(rng.standard_normal((B, S, H, P), np.float32)
                          ).to(DEV).to(args[0].dtype)
    ds = torch.from_numpy(rng.standard_normal((B, H, P, N), np.float32)
                          ).to(DEV)
    return args, dy, ds


def grad_errs(got, want) -> dict:
    """max |got - want| / max |want| of each of the five gradients."""
    return {n: float((g.float() - w.float()).abs().max()
                     / w.float().abs().max().clamp_min(1e-30))
            for n, g, w in zip(GRAD_NAMES, got, want)}


def scan_grads(scan, args, dy, ds, chunk: int):
    """The five gradients of ``scan`` (``ops.ssd`` or the plain
    ``ssd_reference``) by torch.autograd, for the cotangents dy and d(state)
    (none if ``ds`` is None).  Views stay views (``detach`` keeps strides)."""
    leaves = [a.detach().requires_grad_() for a in args]
    y, st = scan(*leaves, chunk=chunk)
    outs, cots = ((y, st), (dy, ds)) if ds is not None else ((y,), (dy,))
    return torch.autograd.grad(outs, leaves, cots)


def ssd_bwd_bound_ms(shape, dtype) -> tuple[float, str]:
    """Least time for the gradient: xh, dy, Bm, Cm, dt and A_log read once
    and dxh, dBm, dCm, ddt and dA_log written once at the HBM rate, against
    the function's least operations at the dtype's peak: per (batch, head,
    chunk) the causal pairs' dy·x~ and dx~ products, Q(Q+1)·2P, and the
    five Q·N·P state products (two chunk sums, G·B, Gᵀ·x~, h0ᵀ·dy),
    10·Q·N·P; and per (batch, group, chunk) the causal pairs' C·Bᵀ, dB and
    dC products, Q(Q+1)·3N (B and C belong to the group, so dB and dC need
    only the sum of L∘r over its heads), at ``ops_ms``'s rate (fp32 as
    three TF32 products).  Both routes are held to it."""
    B, S, H, P, G, N, _ = shape
    el = 2 if dtype == "bfloat16" else 4
    n_bytes = (3 * B * S * H * P * el + 4 * B * S * G * N * el
               + 2 * B * S * H * 4 + 2 * H * 4)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ms(ssd_ops(shape, backward=True), dtype)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ssd_bwd_planted_faults(args, dy, chunk: int, whole, tol: float) -> dict:
    """The check must fail a backward that drops what crosses chunks: the
    kernel's gradient of the first half of the sequence alone (no adjoint
    from the second half) against the whole gradient's dxh there, and of
    the second half alone (no state from the first) against its dCm."""
    from repro_torch.kernels.ssd_scan import ssd_scan

    xh, dt, A_log, Bm, Cm = args
    h = xh.shape[1] // 2
    out = {}
    for name, sl, k in (("adjoint not carried across chunks", slice(0, h), 0),
                        ("inter-chunk dC term dropped", slice(h, None), 4)):
        part = ssd_scan.ssd_backward_cuda(xh[:, sl], dt[:, sl].contiguous(),
                                          A_log, Bm[:, sl], Cm[:, sl],
                                          dy[:, sl], None, chunk)
        want = whole[k][:, sl].float()
        err = float((part[k].float() - want).abs().max() / want.abs().max())
        if not err > tol:
            raise AssertionError(f"SSD backward fault {name!r} passes the "
                                 f"check ({err:.3e} <= {tol})")
        out[name] = err
    return out


def profiled_launch_ms(fn, pattern: str, launches: int,
                       calls: int = 5) -> dict:
    """Each launch's mean device time (ms) in ``calls`` calls of ``fn``
    (torch.profiler), by kernel name (the part of it ``pattern`` finds).
    The profiler can drop ctypes-launched kernels: up to three tries for
    all ``launches`` of a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            m = re.search(pattern, e.key)
            if e.device_type == DeviceType.CUDA and m:
                out[m.group(0)] = e.self_device_time_total / e.count / 1e3
        if len(out) == launches:
            return out
    raise AssertionError(f"the profiler saw {sorted(out)}, not {launches} "
                         f"launches")


def backward_launch_ms(args, dy, chunk: int, calls: int = 5) -> dict:
    """Each launch's mean device time (ms) in ``calls`` gradient calls
    without d(state) (torch.profiler), by kernel name."""
    from repro_torch.kernels.ssd_scan import ssd_scan

    return profiled_launch_ms(
        lambda: ssd_scan.ssd_backward_cuda(*args, dy, None, chunk),
        r"bwd_\w+(<[^>]*>)?", 7, calls)


def ssd_backward_phase(seed: int) -> dict:
    """Each case: the gradient through ``ops.ssd`` (the autograd Function:
    the forward kernel, then one backward launch on the route the case
    names) held against the plain chunked backward and against
    torch.autograd through the plain scan, within SSD_BWD_TOL of each
    gradient's largest value; tensor-core cases also against their CPU
    mirror run on the card and a float64 gradient; the per-(batch, head,
    chunk) block error of dxh; two calls bitwise equal; fp32 cases against
    a float64 gradient; at the training shape the main path's case without
    d(state), two planted faults, the gradient alone (CUDA graph) and each
    launch's device time; then the launches' registers and spill bytes."""
    from repro_torch.kernels.ssd_scan import ops, ref, ssd_scan

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    results = {}
    for k, (shape, dtype, layout, route) in enumerate(SSD_BWD_SHAPES):
        chunk, tol = shape[-1], SSD_BWD_TOL[dtype]
        name = f"ssd_bwd{shape} {dtype}" + ("" if layout == "contiguous"
                                            else f" {layout}")
        args, dy, ds = ssd_bwd_inputs(shape, dtype, seed + 50 + k, layout)
        picked = ssd_scan.backward_route(args[0], args[3], args[4], dy, chunk)
        if picked != route:
            raise AssertionError(f"{name}: routed to {picked}, not {route}")
        before = ssd_counts()
        got = scan_grads(ops.ssd, args, dy, ds, chunk)
        again = scan_grads(ops.ssd, args, dy, ds, chunk)
        torch.cuda.synchronize()
        after = ssd_counts()
        n = {key: after[key] - before[key] for key in after}
        if n["backward"] != 2 or n[f"backward_{route}"] != 2:
            raise AssertionError(f"{name}: {n} launches for two gradients "
                                 f"on the {route}")
        repeat = all(bitwise_equal(a, b) for a, b in zip(got, again))
        if not repeat:
            raise AssertionError(f"{name}: two calls differ")
        for g, a in zip(got, args):
            if g.shape != a.shape or g.dtype != a.dtype or \
                    not bool(torch.isfinite(g).all()):
                raise AssertionError(f"{name}: gradient {tuple(g.shape)} "
                                     f"{g.dtype} not finite or not its "
                                     f"input's shape and dtype")
        del again
        chunked = ref.ssd_backward_reference(*args, dy, ds, chunk)
        auto = scan_grads(ref.ssd_reference, args, dy, ds, chunk)
        errs = {"plain chunked": grad_errs(got, chunked),
                "plain autograd": grad_errs(got, auto)}
        del auto
        if route == TC or dtype == "bfloat16":
            errs["mirror"] = grad_errs(got, ref.ssd_backward_tc_reference(
                *args, dy, ds, chunk))
        else:
            errs["split mirror"] = grad_errs(
                got, ref.ssd_backward_split_reference(*args, dy, ds, chunk))
        err64 = None
        if route == TC or (dtype == "float32" and
                           shape[0] * shape[1] <= 4096):
            exact = ref.ssd_backward_reference(
                *(a.double() for a in args), dy.double(), ds.double(), chunk)
            err64 = {"kernel": grad_errs(got, exact),
                     "plain": grad_errs(chunked, exact)}
            del exact
            if route == TC:
                errs["float64"] = err64["kernel"]
        for side, e in errs.items():
            if not all(v <= tol for v in e.values()):
                raise AssertionError(f"{name}: kernel differs from the "
                                     f"{side} gradient: {e} (tolerance {tol})")
        blk = block_err(got[0], chunked[0], chunk)
        abs_err = max(float((g.float() - w.float()).abs().max())
                      for g, w in zip(got, chunked))
        no_state = faults = None
        if shape == SSD_TRAIN and layout == "mixer views":
            whole = scan_grads(ops.ssd, args, dy, None, chunk)
            no_state = grad_errs(whole, ref.ssd_backward_reference(
                *args, dy, None, chunk))
            if not all(v <= tol for v in no_state.values()):
                raise AssertionError(f"{name}, no d(state): {no_state}")
            faults = ssd_bwd_planted_faults(args, dy, chunk, whole, tol)
            del whole
        del got, chunked
        big = shape[0] * shape[1] > 4096
        call = lambda: ssd_scan.ssd_backward_cuda(  # noqa: E731
            *args, dy, None, chunk)
        ms = timed_ms(call, 5 if big else 20, flush)
        alone = kernel_alone_ms(call, 3) if big else None
        launch_ms = backward_launch_ms(args, dy, chunk) if big else None
        plain = timed_ms(lambda: ref.ssd_backward_reference(*args, dy, None,
                                                            chunk),
                         3 if big else 10, flush)
        auto_ms = timed_ms(lambda: scan_grads(ref.ssd_reference, args, dy,
                                              None, chunk),
                           3 if big else 10, flush)
        b, by = ssd_bwd_bound_ms(shape, dtype)
        b32 = ssd_fp32_rate_ms(shape, backward=True) \
            if dtype == "float32" else None
        results[name] = dict(shape=list(shape), dtype=dtype, layout=layout,
                             route=route, rel_err=errs, tol=tol,
                             dxh_block_rel_err=blk,
                             rel_err_without_dstate=no_state,
                             rel_err_from_float64=err64, bitwise_repeat=repeat,
                             planted_fault_rel_err=faults, ms=ms,
                             alone_ms=alone, launch_ms=launch_ms,
                             plain_ms=plain, plain_autograd_ms=auto_ms,
                             bound_ms=b, bound_by=by, bound_fp32_rate_ms=b32,
                             max_abs_err=abs_err)
        worst = {side: max(e, key=e.get) for side, e in errs.items()}
        log(f"kernel {name} ({route}): of each gradient's largest value, "
            "worst "
            + ", ".join(f"{errs[s][w]:.3e} ({w}) from the {s}"
                        for s, w in worst.items())
            + f" (tolerance {tol}); dxh block err {blk:.3e}; bitwise repeat "
            f"{repeat}"
            + ("" if err64 is None else
               "; from float64 kernel " + ", ".join(
                   f"{n} {v:.2e}" for n, v in err64["kernel"].items())
               + ", plain " + ", ".join(f"{n} {v:.2e}"
                                        for n, v in err64["plain"].items()))
            + ("" if faults is None else "; planted faults: " + ", ".join(
                f"{f} {e:.3e}" for f, e in faults.items()))
            + f"; {ms:.6f} ms a call"
            + ("" if alone is None else f", {alone:.6f} ms alone")
            + f", plain {plain:.6f} ms, plain autograd (forward + backward) "
            f"{auto_ms:.6f} ms, bound {b:.6f} ms ({by})"
            + ("" if b32 is None else f", {b32:.6f} ms at 67 TFLOP/s fp32"))
        if launch_ms is not None:
            log(f"kernel {name} ({route}) per launch: " + ", ".join(
                f"{kn} {v:.6f} ms" for kn, v in launch_ms.items()))
        del args, dy, ds
    info = {}
    for P, N in sorted({(s[3], s[5]) for s, _, _, r in SSD_BWD_SHAPES
                        if r == TC}):
        info[f"P {P}, N {N}"] = rows = ssd_scan.bwd_tc_kernel_info(P, N)
        log(f"kernel ssd backward (tensor_cores) at P {P}, N {N}: "
            + ", ".join(f"{r['launch']} {r['registers']} registers "
                        f"{r['local_bytes']} spill bytes" for r in rows))
    for P, N, dtype in sorted({(s_[3], s_[5], d_)
                               for s_, d_, _, r in SSD_BWD_SHAPES
                               if r == CC}):
        info[f"P {P}, N {N} {dtype} (cuda_cores)"] = rows = \
            ssd_scan.bwd_kernel_info(P, N, getattr(torch, dtype))
        log(f"kernel ssd backward (cuda_cores) at P {P}, N {N} {dtype}: "
            + ", ".join(f"{r['launch']} {r['registers']} registers "
                        f"{r['local_bytes']} spill bytes" for r in rows))
        if any(r["local_bytes"] for r in rows):
            raise AssertionError(f"an SSD backward launch spills at P {P}, "
                                 f"N {N} {dtype}: {rows}")
    results["kernel_info"] = info
    torch.cuda.empty_cache()
    return results


# ------------------------ training mamba2-130m -------------------------- #

TRAIN_BATCH, TRAIN_SEQ = 8, 4096
# tests/test_trainer.py runs 12 steps with the crash after 8; 8 and 4 here
# keep the script inside its time limit
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_F, TRAIN_CRASH = 8, 4, 4, 4
TRAIN_PEAK_CUT_GB = 70.0
# tests/test_trainer.py's optimizer
TRAIN_OPT = dict(name="adamw", lr=3e-3, warmup_steps=2, decay_steps=1000,
                 clip_norm=1.0)
# The training paths' peak learning rate, the order of those published for
# models of these sizes: TRAIN_OPT's 3e-3 (tests/test_trainer.py's, for
# reduced configs) overshoots at full width — on hubert-xlarge the loss on
# one batch went 6.71, 7.50, 7.04, 7.19 over four steps; mamba2-130m's 12
# steps at 3e-3 spike (11.35 at step 10 of one run), so whether the mean
# of the last four falls below the first four's is a draw of the init.
# tools/loss_fall.py on an H100 80GB HBM3 (700 W), seeds 0, 1 and 2, the
# mean of the first four losses -> the last four's:
#   3e-3, per-block draws   10.707->10.870  10.707->11.075  10.708->10.693
#   3e-3, whole-leaf draws  10.702->10.649  10.701->10.711  10.698->10.821
#   3e-4, per-block draws   10.768->10.208  10.768->10.206  10.770->10.209
#   3e-4, whole-leaf draws  10.769->10.209  10.768->10.206  10.768->10.201
# (whole-leaf: each leaf in one fp32 draw, as init_params drew before it
# drew a block's slice at a time; at 3e-4 every one of the six runs fell
# at every step).  Do not raise it back to 3e-3: the check would be a coin.
TRAIN_LR = 3e-4


def zero_ssd_counts() -> None:
    from repro_torch.kernels.ssd_scan import ssd_scan
    ssd_scan.LAUNCHES = ssd_scan.TENSOR_CORE_LAUNCHES = 0
    ssd_scan.CUDA_CORE_LAUNCHES = ssd_scan.BACKWARD_LAUNCHES = 0
    ssd_scan.BACKWARD_TENSOR_CORE_LAUNCHES = 0
    ssd_scan.BACKWARD_CUDA_CORE_LAUNCHES = 0


def zero_conv_counts() -> None:
    from repro_torch.kernels.causal_conv import causal_conv
    causal_conv.LAUNCHES = causal_conv.BACKWARD_LAUNCHES = 0


def conv_counts() -> dict:
    """The mixer's conv kernels' calls since the counts were last zeroed."""
    from repro_torch.kernels.causal_conv import causal_conv
    return dict(forward=causal_conv.LAUNCHES,
                backward=causal_conv.BACKWARD_LAUNCHES)


def ssd_counts() -> dict:
    from repro_torch.kernels.ssd_scan import ssd_scan
    return dict(forward=ssd_scan.LAUNCHES,
                tensor_cores=ssd_scan.TENSOR_CORE_LAUNCHES,
                cuda_cores=ssd_scan.CUDA_CORE_LAUNCHES,
                backward=ssd_scan.BACKWARD_LAUNCHES,
                backward_tensor_cores=ssd_scan.BACKWARD_TENSOR_CORE_LAUNCHES,
                backward_cuda_cores=ssd_scan.BACKWARD_CUDA_CORE_LAUNCHES)


class JournaledSteps:
    """The trainer's step as ``train_step`` runs it (``grads_and_metrics``,
    then ``apply_step`` with the journal), timed, and each step's grads
    copied to the host after the update and hashed there by the plain
    version in a worker thread, to hold ``metrics["integrity"]`` to."""

    def __init__(self, cfg, opt_cfg):
        self.cfg, self.opt_cfg = cfg, opt_cfg
        self.pool = ThreadPoolExecutor(1)
        self.plain, self.integrity, self.ms = [], [], []

    def __call__(self, state, batch):
        from repro_torch.kernels.checksum import ref
        from repro_torch.train import step as S
        from repro_torch.tree import leaf_paths

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads, metrics = S.grads_and_metrics(state["params"], batch, self.cfg)
        new_state, metrics = S.apply_step(state, grads, metrics, self.opt_cfg,
                                          journal=True)
        self.integrity.append(metrics["integrity"].cpu())
        self.ms.append((time.perf_counter() - t0) * 1e3)
        host = [g.detach().cpu() for _, g in leaf_paths(grads)]
        self.plain.append(self.pool.submit(
            lambda: [int(ref.tensor_checksum(g)) for g in host]))
        return new_state, metrics

    def check(self, what: str) -> int:
        """Every step's integrity equals the plain hash; returns the steps."""
        for i, (got, fut) in enumerate(zip(self.integrity, self.plain)):
            if got.tolist() != fut.result():
                raise AssertionError(f"{what}: step {i}'s integrity "
                                     f"{got.tolist()} is not the plain hash "
                                     f"of its grads {fut.result()}")
        self.pool.shutdown()
        return len(self.integrity)


def profiled_train_step(state, batch, cfg, opt_cfg):
    """One step as ``train_step`` runs it, with the SSD launches read after
    the forward and after the backward and the hash launches after the
    update.  Returns (new_state, counts)."""
    from repro_torch.models import model as M
    from repro_torch.train import step as S
    from repro_torch.tree import leaf_paths, map_with_path

    zero_ssd_counts()
    zero_hash_counts()
    leaves = {n: t.detach().requires_grad_(True)
              for n, t in leaf_paths(state["params"])}
    loss, metrics = M.forward_train(
        map_with_path(lambda n, _: leaves[n], state["params"]), cfg, batch)
    forward = ssd_counts()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    backward = ssd_counts()
    by_name = dict(zip(leaves, grads))
    new_state, metrics = S.apply_step(
        state, map_with_path(lambda n, _: by_name[n], state["params"]),
        {k: v.detach() for k, v in metrics.items()}, opt_cfg, journal=True)
    torch.cuda.synchronize()
    return new_state, dict(
        ssd_forward=forward["forward"],
        ssd_recompute=backward["forward"] - forward["forward"],
        ssd_backward=backward["backward"],
        ssd_backward_tensor_core=backward["backward_tensor_cores"],
        ssd_backward_cuda_core=backward["backward_cuda_cores"],
        ssd_tensor_core=backward["tensor_cores"], hash=hash_counts(),
        loss=float(metrics["loss"]))


def train_phase(seed: int, card: str) -> dict:
    """mamba2-130m at its published widths and depth, bf16 compute over fp32
    master params, 8 x 4096 tokens a step from the synthetic pipeline,
    AdamW: a profiled step, then tests/test_trainer.py's schedule cut to 8
    steps through the journaled, checkpointed trainer (a checkpoint every
    4, F = 4) and a second deployment that stops after step 4, restores in
    a fresh trainer and finishes — with the manifests and journal on a
    replicated log (local+remote, 1 backup, W = 2) and the checkpoints on 2
    in-memory stores at W = 2; every step journaled with its grads' hashes."""
    from repro_torch.checkpoint import (CheckpointConfig, CheckpointManager,
                                        ObjectStore, ReplicatedStore)
    from repro_torch.configs import get_config
    from repro_torch.core.replication import build_replica_set
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.launch.train import check_trainable
    from repro_torch.optim import OptConfig
    from repro_torch.train import step as S
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import leaf_paths

    cfg = get_config("mamba2-130m")
    check_trainable(cfg, DEV, TRAIN_SEQ)
    opt = OptConfig(**dict(TRAIN_OPT, lr=TRAIN_LR))
    reduced = ["weights random from --seed (init_params)",
               "synthetic Markov tokens (SyntheticDataset)",
               f"tests/test_trainer.py's 12 steps -> {TRAIN_STEPS}, the crash "
               f"after 8 -> {TRAIN_CRASH} (the script's time limit)"]
    out: dict = {}

    # the profiled step: the second of two from a fresh state
    batch = TRAIN_BATCH
    while True:
        torch.cuda.reset_peak_memory_stats()
        data = SyntheticDataset(cfg, DataConfig(batch=batch,
                                                seq_len=TRAIN_SEQ))
        state = S.init_train_state(
            cfg, opt, torch.Generator(device=DEV).manual_seed(seed), DEV)
        state, _ = S.train_step(state, data.tensors_at(0, DEV), cfg, opt,
                                journal=True)
        b1 = data.tensors_at(1, DEV)
        (state, counts), prof = device_window(
            lambda: profiled_train_step(state, b1, cfg, opt))
        step_ms = prof["wall_ms"]
        peak = torch.cuda.max_memory_allocated() / 1e9
        if peak <= TRAIN_PEAK_CUT_GB or batch == 4:
            break
        reduced.append(f"batch {TRAIN_BATCH} -> 4: peak {peak:.3f} GB > "
                       f"{TRAIN_PEAK_CUT_GB} GB")
        batch = 4
        del state, b1
        torch.cuda.empty_cache()
    del state, b1
    torch.cuda.empty_cache()
    out.update(describe(cfg, reduced, card))
    n_leaves = len(list(leaf_paths(S.train_state_specs(cfg, opt)["params"])))
    want = (cfg.n_layers, cfg.n_layers, cfg.n_layers)
    got = (counts["ssd_forward"], counts["ssd_recompute"],
           counts["ssd_backward"])
    if got != want or counts["ssd_tensor_core"] != 2 * cfg.n_layers or \
            counts["ssd_backward_tensor_core"] != cfg.n_layers or \
            counts["ssd_backward_cuda_core"] != 0 or \
            counts["hash"]["launches"] != n_leaves:
        raise AssertionError(f"profiled step's launches {counts}: expected "
                             f"{want} SSD (forward, remat, backward) on the "
                             f"tensor cores and {n_leaves} hash launches")
    tokens = batch * TRAIN_SEQ
    out["profiled_step"] = dict(counts, profile=prof, step_ms=step_ms,
                                tokens_per_s=tokens / step_ms * 1e3,
                                peak_memory_gb=peak, batch=batch,
                                seq=TRAIN_SEQ)
    log(f"train profiled step ({batch} x {TRAIN_SEQ} tokens, {card}): "
        f"{step_ms:.3f} ms ({tokens / step_ms * 1e3:.1f} tokens/s), peak "
        f"device memory {peak:.3f} GB; SSD launches {counts['ssd_forward']} "
        f"forward + {counts['ssd_recompute']} remat recompute (all "
        f"{counts['ssd_tensor_core']} on the tensor cores) + "
        f"{counts['ssd_backward']} backward ({counts['ssd_backward_tensor_core']}"
        f" on the tensor cores); hash launches {counts['hash']}")
    log_profile("train step", prof)

    def deployment():
        rs = build_replica_set(mode="local+remote", capacity=1 << 20,
                               n_backups=1, write_quorum=2, device=DEV)
        return rs, [ObjectStore(f"s{i}") for i in range(2)]

    def trainer(rs, stores):
        mgr = CheckpointManager(ReplicatedStore(stores, write_quorum=2),
                                rs.log, CheckpointConfig(force_freq=TRAIN_F))
        tr = Trainer(cfg, opt, SyntheticDataset(
            cfg, DataConfig(batch=batch, seq_len=TRAIN_SEQ)), mgr,
            TrainerConfig(total_steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY,
                          journal_freq=TRAIN_F, seed=seed, async_ckpt=False),
            device=DEV)
        tr.step_fn = JournaledSteps(cfg, opt)
        return tr

    zero_ssd_counts()
    zero_conv_counts()
    zero_hash_counts()
    t0 = time.perf_counter()
    rs, stores = deployment()
    try:
        ref_tr = trainer(rs, stores)
        ref_tr.init_or_restore()
        rep = ref_tr.run()
        ref_tr.mgr.close()
    finally:
        rs.shutdown()
    run_s = time.perf_counter() - t0
    main_counts = dict(ssd=ssd_counts(), conv=conv_counts(),
                       hash=hash_counts())
    ref_steps = ref_tr.step_fn
    final = ref_tr.state
    del ref_tr, stores, rs

    rs, stores = deployment()
    try:
        first = trainer(rs, stores)
        first.init_or_restore()
        first.run(n_steps=TRAIN_CRASH)     # "crash": the trainer is dropped
        first.mgr.close()
        first_steps = first.step_fn
        del first
        second = trainer(rs, stores)
        restored = second.init_or_restore()
        seated = second.data.step
        rep2 = second.run()
        second.mgr.close()
        log_stats = rs.log.stats()
    finally:
        rs.shutdown()
    checked = sum(s.check(w) for s, w in (
        (ref_steps, "train run"), (first_steps, "train run to the crash"),
        (second.step_fn, "resumed run")))
    losses = np.array(rep.losses)
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"train losses {rep.losses}")
    first4, last4 = float(losses[:4].mean()), float(losses[-4:].mean())
    if not last4 < first4:
        raise AssertionError(f"loss did not fall: {rep.losses}")
    if restored != TRAIN_CRASH or seated < TRAIN_CRASH:
        raise AssertionError(f"restored step {restored}, data re-seated at "
                             f"{seated}")
    tail = rep.losses[TRAIN_CRASH:]
    if not np.allclose(rep2.losses, tail, rtol=1e-5, atol=0):
        raise AssertionError(f"resumed losses {rep2.losses} differ from the "
                             f"uninterrupted run's {tail}")
    loss_bitwise = rep2.losses == tail
    params_bitwise = all(bitwise_equal(a, b) for (_, a), (_, b) in zip(
        leaf_paths(final), leaf_paths(second.state)))
    expect = TRAIN_STEPS * cfg.n_layers
    if main_counts["ssd"]["backward"] != expect or \
            main_counts["ssd"]["backward_tensor_cores"] != expect or \
            main_counts["ssd"]["backward_cuda_cores"] != 0 or \
            main_counts["ssd"]["forward"] != 2 * expect:
        raise AssertionError(f"train run's SSD launches {main_counts['ssd']}: "
                             f"expected {2 * expect} forward, {expect} "
                             f"backward")
    if main_counts["conv"] != dict(forward=2 * expect, backward=expect):
        raise AssertionError(f"train run's conv launches "
                             f"{main_counts['conv']}: expected {2 * expect} "
                             f"forward, {expect} backward")
    ms = ref_steps.ms[1:]
    out.update(
        losses=rep.losses, resumed_losses=rep2.losses,
        first4_mean=first4, last4_mean=last4, restored_step=restored,
        data_reseated_at=seated, resumed_losses_bitwise_equal=loss_bitwise,
        final_params_bitwise_equal=params_bitwise,
        integrity_steps_checked=checked, run_s=run_s,
        step_ms_median=float(np.median(ms)),
        tokens_per_s=batch * TRAIN_SEQ / float(np.median(ms)) * 1e3,
        ckpts_saved=rep.ckpts_saved, ckpts_skipped=rep.ckpts_skipped,
        main_path_counts=main_counts, log_stats={
            k: log_stats[k] for k in ("next_lsn", "durable_lsn", "used")})
    log(f"train run: {TRAIN_STEPS} steps of {batch} x {TRAIN_SEQ} in "
        f"{run_s:.3f} s ({rep.ckpts_saved} checkpoints), median step "
        f"{out['step_ms_median']:.3f} ms ({out['tokens_per_s']:.1f} "
        f"tokens/s); loss {rep.losses[0]:.4f} -> {rep.losses[-1]:.4f} (mean "
        f"of first 4 {first4:.4f}, last 4 {last4:.4f}); main path launches "
        f"{main_counts}")
    log(f"train resume: restored step {restored}, data re-seated at "
        f"{seated}; steps {TRAIN_CRASH + 1}-{TRAIN_STEPS} within rtol 1e-5 "
        f"of the uninterrupted run, losses bitwise equal {loss_bitwise}, "
        f"final params bitwise equal {params_bitwise}; integrity equal to the "
        f"plain hash of the grads on the CPU at all {checked} steps")
    del final, second
    torch.cuda.empty_cache()
    return out


TRAIN_CPU_LAYERS, TRAIN_CPU_TOKENS = 2, 512
# Loss within 1e-5 relative; each grad leaf and each new first and second
# moment leaf within 1e-4 of the leaf's largest magnitude (fp32 sums in
# other orders on the two devices; the CPU tests see 1e-6 between two
# frameworks); each new param leaf within 1e-4 of the leaf's largest update
# plus two fp32 spacings of its largest value (p - lr·u rounds to p's
# spacing), where the grad is at least 1e-3 of the leaf's largest: from
# zero moments AdamW moves an element by lr·g/(|g| + eps), about ±lr, whose
# sign is round-off where |g| is that small (those elements are counted,
# not compared).  (The first statement, without the spacing term, was made
# before a run whose CPU grads were NaN — see PERF.md.)
TRAIN_CPU_TOL = 1e-4
TRAIN_CPU_SIGN_FLOOR = 1e-3
FP32_SPACING = 2.0 ** -23


def per_chunk_backward(real):
    """A planted fault: the backward kernel run on each chunk as a sequence
    of its own, so no adjoint or state crosses a chunk boundary."""
    def fault(xh, dt, A_log, Bm, Cm, dy, dstate, chunk):
        B, S = xh.shape[:2]
        n = B * (S // chunk)

        def r(t):
            return t.contiguous().reshape(n, chunk, *t.shape[2:])
        g = real(r(xh), r(dt), A_log, r(Bm), r(Cm), r(dy), None, chunk)
        return (g[0].reshape(xh.shape), g[1].reshape(dt.shape), g[2],
                g[3].reshape(Bm.shape), g[4].reshape(Cm.shape))
    return fault


def train_card_vs_cpu_phase(seed: int) -> dict:
    """mamba2-130m at full width cut to 2 layers, fp32: one AdamW step of
    1 x 512 tokens from the same state (zero moments at step 2, so lr > 0)
    on the card (the kernels) and on the CPU (the plain versions), held to
    TRAIN_CPU_TOL; with the backward kernel run chunk by chunk the grads
    must move past it."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.optim import OptConfig
    from repro_torch.train import step as S
    from repro_torch.tree import leaf_paths, tree_map

    cfg = replace(get_config("mamba2-130m"), n_layers=TRAIN_CPU_LAYERS,
                  compute_dtype="float32")
    opt = OptConfig(**TRAIN_OPT)
    host = S.init_train_state(cfg, opt, torch.Generator().manual_seed(
        seed + 23), device="cpu")
    host["step"] = torch.tensor(2, dtype=torch.int32)
    card = tree_map(lambda t: t.to(DEV), host)
    nb = SyntheticDataset(cfg, DataConfig(batch=1, seq_len=TRAIN_CPU_TOKENS,
                                          seed=seed)).batch_at(0)
    batch = {k: torch.from_numpy(v).long() for k, v in nb.items()}

    def step(state, dev):
        b = {k: v.to(dev) for k, v in batch.items()}
        grads, met = S.grads_and_metrics(state["params"], b, cfg)
        new, met = S.apply_step(state, grads, met, opt)
        return tree_map(lambda t: t.cpu(), (grads, new)), float(met["loss"])

    def leaf_errs(a, b, scale=None):
        out = {}
        for (n, x), (_, y) in zip(leaf_paths(a), leaf_paths(b)):
            s = float((scale or {}).get(n, y.abs().max().clamp_min(1e-30)))
            out[n] = float((x - y).abs().max()) / s
        return out

    zero_ssd_counts()
    zero_conv_counts()
    (g_card, new_card), loss_card = step(card, DEV)
    counts, conv = ssd_counts(), conv_counts()
    if counts["backward"] != cfg.n_layers or \
            counts["backward_cuda_cores"] != cfg.n_layers or \
            counts["forward"] != 2 * cfg.n_layers or \
            counts["cuda_cores"] != 2 * cfg.n_layers:
        raise AssertionError(f"card step's SSD launches {counts}: the fp32 "
                             f"scans and backward belong on the "
                             f"\"cuda_cores\" route")
    if conv != dict(forward=2 * cfg.n_layers, backward=cfg.n_layers):
        raise AssertionError(f"card step's conv launches {conv}: expected "
                             f"{2 * cfg.n_layers} forward, {cfg.n_layers} "
                             f"backward")
    (g_cpu, new_cpu), loss_cpu = step(host, "cpu")
    if ssd_counts() != counts or conv_counts() != conv:
        raise AssertionError("the CPU step launched a kernel")
    grad_err = leaf_errs(g_card, g_cpu)
    moment_err = leaf_errs(new_card["opt"], new_cpu["opt"])
    param_err, skipped = {}, 0
    old = dict(leaf_paths(host["params"]))
    grads = dict(leaf_paths(g_cpu))
    for (n, pc), (_, pp) in zip(leaf_paths(new_card["params"]),
                                leaf_paths(new_cpu["params"])):
        g = grads[n].abs()
        keep = (g >= TRAIN_CPU_SIGN_FLOOR * g.max()) | (g == 0)
        skipped += int((~keep).sum())
        upd = (pp - old[n]).abs().max()
        scale = TRAIN_CPU_TOL * upd + 2 * FP32_SPACING * pp.abs().max()
        param_err[n] = TRAIN_CPU_TOL * float(((pc - pp).abs() * keep).max()
                                             / scale.clamp_min(1e-30))
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    worst = {k: max(v.values()) for k, v in (("grads", grad_err),
                                             ("moments", moment_err),
                                             ("params", param_err))}
    log(f"train card vs cpu (fp32, {TRAIN_CPU_LAYERS} layers, 1 x "
        f"{TRAIN_CPU_TOKENS}): loss {loss_card:.7f} / {loss_cpu:.7f} "
        f"({loss_rel:.3e} relative, tolerance 1e-5); worst leaf "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f" (tolerance {TRAIN_CPU_TOL}); {skipped} elements with |g| below "
        f"{TRAIN_CPU_SIGN_FLOOR} of their leaf's largest not compared")
    if not (loss_rel <= 1e-5 and all(v <= TRAIN_CPU_TOL
                                     for e in (grad_err, moment_err,
                                               param_err)
                                     for v in e.values())):
        raise AssertionError(f"card and CPU train steps disagree: loss "
                             f"{loss_rel:.3e}, {worst}")
    real = ssd_scan.ssd_backward_cuda
    ssd_scan.ssd_backward_cuda = per_chunk_backward(real)
    try:
        (g_fault, _), _ = step(card, DEV)
    finally:
        ssd_scan.ssd_backward_cuda = real
    fault_errs = leaf_errs(g_fault, g_cpu)
    if not all(v == v for v in fault_errs.values()):     # NaN
        raise AssertionError(f"planted fault's grads not finite: {fault_errs}")
    fault = max(fault_errs.values())
    log(f"train card vs cpu, backward run chunk by chunk: worst grad leaf "
        f"{fault:.3e} (must exceed {TRAIN_CPU_TOL})")
    if not fault > TRAIN_CPU_TOL:
        raise AssertionError("a backward that drops the carried adjoint "
                             "passes the card-vs-CPU check")
    del card
    torch.cuda.empty_cache()
    return dict(loss_rel_err=loss_rel, worst_leaf_err=worst,
                grad_leaf_err=grad_err, sign_floor_skipped=skipped,
                planted_fault_grad_err=fault, tol=TRAIN_CPU_TOL,
                ssd_counts=counts, conv_counts=conv)


# ---------------------------- flash attention ---------------------------- #

def flash_case(name, shape, dtype, *, layout="bhsd", q_mul=1.0, faults=(),
               dv=None, route=None, **kw) -> dict:
    """One shape of the flash phase.  ``layout`` "bshd" makes q, k, v
    permuted [B,S,H,D] views, as the layer passes them, and "mla" makes v
    the [..., Dv:] view of a [B,S,H,2·Dv] expansion, as MLA's prefill
    passes it; ``dv`` is v's head dim (D unless given); ``q_mul`` scales q
    (16 puts the scores in the softcap's range); each of ``faults`` names
    options of a wrong function the check must be able to tell apart
    (``v_from="k_nope"``: v read from k's first Dv columns); ``route``,
    where given, is the route the plan must choose for the case."""
    return dict(name=name, shape=shape, dtype=dtype, layout=layout,
                q_mul=q_mul, faults=list(faults), dv=dv, route=route, kw=kw)


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
               faults=[dict(window=None)], causal=True, window=4096, cap=50.0),
    flash_case(f"gemma2 global {G2} scores x16", G2, "bfloat16", layout="bshd",
               q_mul=16.0, faults=[dict(cap=None)], causal=True, cap=50.0),
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
# the same mask variants at the tensor-core pairs of hubert (D 80: two
# 64-column boxes, the second zero past column 80) and MLA (D 192 over
# three boxes, Dv 128), and a ragged length at each
for _shape, _dv in (((1, 4, 2, 256, 80), None), ((1, 4, 4, 256, 192), 128)):
    _n = f"{_shape}" + (f" dv {_dv}" if _dv else "")
    FLASH_CASES += [
        flash_case(f"causal {_n}", _shape, "bfloat16", dv=_dv,
                   route="tensor_cores", causal=True),
        flash_case(f"full {_n}", _shape, "bfloat16", dv=_dv,
                   route="tensor_cores", causal=False),
        flash_case(f"window 128 {_n}", _shape, "bfloat16", dv=_dv,
                   route="tensor_cores", causal=True, window=128),
        flash_case(f"cap 50 {_n}", _shape, "bfloat16", dv=_dv,
                   route="tensor_cores", causal=True, cap=50.0),
        flash_case(f"window 64 cap 30 {_n}", _shape, "bfloat16", dv=_dv,
                   route="tensor_cores", causal=True, window=64, cap=30.0),
        flash_case(f"window 16 below a tile {_n}", _shape, "bfloat16",
                   dv=_dv, route="tensor_cores", causal=True, window=16),
        flash_case(f"ragged S 1000 {_n}", (*_shape[:3], 1000, _shape[4]),
                   "bfloat16", dv=_dv, route="tensor_cores", causal=True,
                   window=100)]
# the prefill shapes of this slice's model paths: deepseek-v3's MLA (2 x
# 4096 tokens, 128 heads, q/k head dim 192 = qk_nope 128 + qk_rope 64, v
# head dim 128, scale 1/sqrt(192)) in bf16 (the tensor-core kernel at
# (192, 128)) and fp32 (the CUDA-core kernel) as the layer lays them out,
# where a dropped causal mask and v read from k_nope must fail the row
# check; and hubert-xlarge's non-causal encoder (8 x 1500 frames, 16 heads
# of 80, the tensor-core kernel at (80, 80)), where a causal mask must fail
# it; and llava-next-34b's prefill (2 x (2880 patches + 1216 tokens), 56
# heads over 8 of 128, the tensor-core kernel) as the layer lays it out,
# where a dropped causal mask must fail it
MLA = (2, 128, 128, 4096, 192)
MLA_DV = 128
HUBERT = (8, 16, 16, 1500, 80)
LLAVA = (2, 56, 8, 4096, 128)
for _dt, _route in (("bfloat16", "tensor_cores"), ("float32", "cuda_cores")):
    FLASH_CASES.append(flash_case(
        f"mla {MLA} dv {MLA_DV}", MLA, _dt, layout="mla", dv=MLA_DV,
        route=_route, faults=[dict(causal=False), dict(v_from="k_nope")],
        causal=True, scale=1.0 / float(np.sqrt(MLA[4]))))
FLASH_CASES.append(flash_case(f"hubert {HUBERT}", HUBERT, "bfloat16",
                              layout="bshd", route="tensor_cores",
                              faults=[dict(causal=True)], causal=False))
# the mma.sync route's other inputs at training widths: hubert's encoder in
# fp32 (the card-vs-CPU steps), and starcoder2's prefill as bf16 copies 8
# bytes past 16-byte alignment (TMA cannot read them)
FLASH_CASES.append(flash_case(f"hubert {HUBERT}", HUBERT, "float32",
                              layout="bshd", route="cuda_cores",
                              faults=[dict(causal=True)], causal=False))
FLASH_CASES.append(flash_case(f"starcoder2 {(2, 24, 2, 4096, 128)} misaligned",
                              (2, 24, 2, 4096, 128), "bfloat16",
                              layout="shifted", route="cuda_cores",
                              faults=[dict(causal=False)], causal=True))
FLASH_CASES.append(flash_case(f"llava {LLAVA}", LLAVA, "bfloat16",
                              layout="bshd", faults=[dict(causal=False)],
                              causal=True))
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


def shifted_copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` 4 elements past the allocation's start:
    8 bytes past 16-byte alignment in bf16, which TMA cannot read."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    return buf[4:].view(t.shape).copy_(t)


def flash_inputs(case: dict, seed: int):
    """q [B,H,S,D], k [B,KV,S,D] and v [B,KV,S,Dv] from the seed, in the
    case's dtype; for layouts "bshd" and "mla" views of [B,S,H,·] storage,
    for "mla" v the [..., Dv:] half of a [B,S,KV,2·Dv] tensor; "shifted":
    "bhsd" copies 4 elements past 16-byte alignment."""
    if case["layout"] == "shifted":
        return [shifted_copy(t) for t in
                flash_inputs(dict(case, layout="bhsd"), seed)]
    B, H, KV, S, D = case["shape"]
    dv = case["dv"] or D
    gen = torch.Generator(device=DEV).manual_seed(seed)
    dt = getattr(torch, case["dtype"])
    out = []
    for n, (heads, width) in enumerate(((H, D), (KV, D), (KV, dv))):
        if case["layout"] == "mla" and n == 2:
            width = 2 * dv
        shape = (B, heads, S, width) if case["layout"] == "bhsd" else \
            (B, S, heads, width)
        t = torch.randn(shape, device=DEV, generator=gen)
        if n == 0:
            t *= case["q_mul"]
        t = t.to(dt)
        if case["layout"] == "mla" and n == 2:
            t = t[..., dv:]
        out.append(t if case["layout"] == "bhsd" else t.transpose(1, 2))
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


def ops_ms(ops: int, dtype: str) -> float:
    """Least time for ``ops`` operations of attention's products: bf16 on
    the tensor cores, fp32 as three TF32 products on them."""
    if dtype == "bfloat16":
        return ops / BF16_OPS_PER_S * 1e3
    return 3 * ops / TF32_OPS_PER_S * 1e3


def flash_bound_ms(shape, kw, dtype, dv=None) -> tuple[float, str]:
    """Least time for the attention: q, k [.., D] and v [.., Dv] read and
    o [.., Dv] written once at the HBM rate, against 2·B·H·(D + Dv)
    operations per unmasked pair (the two products) at the peak rate for
    the dtype (bf16 tensor cores; fp32 as three TF32 products each)."""
    B, H, KV, S, D = shape
    dv = dv or D
    el = 2 if dtype == "bfloat16" else 4
    n_bytes = (B * H * S * (D + dv) + B * KV * S * (D + dv)) * el
    ops = 2 * B * H * (D + dv) * attended_pairs(S, kw.get("causal", True),
                                                 kw.get("window"))
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ms(ops, dtype)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def plain_with_fault(q, k, v, kw: dict, fault: dict):
    """The plain version of a wrong function: the case's options changed
    by ``fault``, or (``v_from="k_nope"``) v read from k's first Dv
    columns."""
    from repro_torch.kernels.flash_attention import ref

    fault = dict(fault)
    if fault.pop("v_from", None) == "k_nope":
        v = k[..., :v.shape[-1]]
    return ref.attention_reference(q, k, v, **{**kw, **fault})


def flash_kernel_phase(seed: int) -> dict:
    """Each case: one launch, held against the plain version elementwise
    (FLASH_TOL) and row by row (FLASH_ROW_TOL); for each fault the case
    names, the plain version of that wrong function must fail the row
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
        # every case's views but the "shifted" copies are 16-byte aligned,
        # so the C side takes the plan's route (the copies go to the
        # mma.sync kernel); the launch counters below say which it took
        route = fa.tile_plan(q.dtype, shape[4], case["dv"]).route
        if case["layout"] == "shifted":
            route = "cuda_cores"
        if case["route"] not in (None, route):
            raise AssertionError(f"flash {name} {dtype}: plan {route}, "
                                 f"expected {case['route']}")
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
        mirror_err = None
        if dtype == "float32":
            # the kernel's own arithmetic (three TF32 products a product)
            # on the CPU's terms: ref.attention_split_reference
            mirror = plain_by_heads(
                lambda q_, k_, v_: ref.attention_split_reference(
                    q_, k_, v_, **kw), q, k, v, heads=4)
            mirror_err = row_rel_err(got, mirror)
            del mirror
            if not mirror_err <= row_tol:
                raise AssertionError(f"flash {name} {dtype}: kernel differs "
                                     f"from the split mirror by {mirror_err} "
                                     f"of a row (tolerance {row_tol})")
        fault_errs = {}
        for fault in case["faults"]:
            wrong = plain_with_fault(q, k, v, kw, fault)
            fault_errs[str(fault)] = row_rel_err(got, wrong)
            del wrong
            if not fault_errs[str(fault)] > row_tol:
                raise AssertionError(
                    f"flash {name}: the row check cannot tell the kernel from "
                    f"the plain version with {fault} "
                    f"({fault_errs[str(fault)]})")
        del got
        big = shape[0] * shape[1] * S * S >= 2 * 16 * 8192 * 8192
        ms = timed_ms(lambda: ops.flash_attention(q, k, v, **kw),
                      5 if big else 20, flush)
        alone = info = None
        if route == "cuda_cores":
            # the mma.sync kernel alone (a CUDA graph of back-to-back
            # launches), and its registers and spills
            alone = kernel_alone_ms(
                lambda: fa.flash_attention_cuda(q, k, v, **kw),
                3 if big else 10)
            info = fa.kernel_info(q.dtype, shape[4], kw.get("cap") is not None,
                                  v_head_dim=case["dv"] or shape[4],
                                  route="cuda_cores")
            if info["local_bytes"]:
                raise AssertionError(f"flash {name} {dtype}: the mma.sync "
                                     f"kernel spills: {info}")
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
                        q, k, v, is_causal=kw["causal"], scale=kw.get("scale"),
                        enable_gqa=True)
                library_err = row_rel_err(lib(), want)
                library = timed_ms(lib, 5 if big else 20, flush)
            except Exception as e:       # the yardstick only: recorded
                library_error = f"{type(e).__name__}: {e}"[:300]
        b, by = flash_bound_ms(shape, kw, dtype, case["dv"])
        key = f"{name} {dtype}"
        results[key] = dict(shape=list(shape), dv=case["dv"] or shape[4],
                            options=kw, dtype=dtype,
                            route=route, layout=case["layout"],
                            q_mul=case["q_mul"],
                            max_abs_err=err, tol=tol, row_rel_err=row_err,
                            row_tol=row_tol, mirror_row_rel_err=mirror_err,
                            fault_row_rel_err=fault_errs, ms=ms,
                            alone_ms=alone,
                            registers=info and info["registers"],
                            local_bytes=info and info["local_bytes"],
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
        fault_txt = "".join(f"; with {f} the plain version is {e:.3e} of a "
                            f"row off" for f, e in fault_errs.items())
        q_txt = "" if case["q_mul"] == 1.0 else f" q x{case['q_mul']:g}"
        dv_txt = "" if case["dv"] is None else f" Dv {case['dv']}"
        mirror_txt = "" if mirror_err is None else \
            f", split mirror row err {mirror_err:.3e}"
        alone_txt = "" if alone is None else (
            f", {alone:.6f} ms alone, {info['registers']} registers "
            f"{info['local_bytes']} spill bytes")
        log(f"kernel flash {key} {kw} {case['layout']}{dv_txt}{q_txt} ({route}): "
            f"max abs err {err:.3e} (within {tol} + {tol}·|plain|), row err "
            f"{row_err:.3e} (within {row_tol:.4g}){mirror_txt}{fault_txt}; "
            f"{ms:.6f} ms a call{alone_txt}, plain {plain:.6f} ms, bound "
            f"{b:.6f} ms ({by}), library {lib_txt}")
        del q, k, v, want
        torch.cuda.empty_cache()
    return results


def flash_attributes() -> list:
    """``cudaFuncGetAttributes`` of each flash kernel: registers a thread,
    local (spill) bytes a thread, shared bytes a block (dynamic + static)
    and threads a block, for bf16 at every tensor-core (D, Dv) pair with
    and without a softcap, and for the mma.sync kernel (the "cuda_cores"
    route) in fp32 and bf16 at each of its widths (64, 128, 192, 256).  A
    kernel that spills fails the run."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    out = []
    mma_pairs = [(32, 32), (64, 64), (80, 80), (128, 128), (192, 128),
                 (256, 256)]
    for dtype, pairs, caps, route in (
            (torch.bfloat16, fa.TENSOR_CORE_PAIRS, (False, True), None),
            (torch.float32, mma_pairs, (False,), "cuda_cores"),
            (torch.bfloat16, mma_pairs, (False,), "cuda_cores")):
        for D, Dv in pairs:
            for capped in caps:
                info = fa.kernel_info(dtype, D, capped, v_head_dim=Dv,
                                      route=route)
                if (info["route"] == "tensor_cores") != (route is None):
                    raise AssertionError(f"{dtype} ({D}, {Dv}) {route}: the "
                                         f"card reports {info}")
                out.append(dict(
                    dtype=str(dtype).removeprefix("torch."), head_dim=D,
                    v_head_dim=Dv, softcap=capped, route=info["route"],
                    registers=info["registers"],
                    local_bytes=info["local_bytes"],
                    shared_bytes=info["smem_bytes"]
                    + info["static_smem_bytes"],
                    threads=info["max_threads"]))
                if info["local_bytes"]:
                    raise AssertionError(f"the {info['route']} flash kernel "
                                         f"spills at D={D}, Dv={Dv}: {info}")
    return out


# ---------------------- flash attention backward ------------------------- #

# the training paths' attention shapes (1 x 8192 for gemma2, 2 x 4096 for
# starcoder2, 8 x 1500 frames for hubert, 1 x 4096 for deepseek-v3's MLA),
# as the layer lays them out, in bf16; gemma2's local layer with scores in
# the softcap's range (q x 16: the softcap's derivative is then far from
# 1), where the four planted wrong backwards of ``ref.FAULTS`` must fail
# the row check; hubert's in fp32; and starcoder2's as contiguous copies
# 8 bytes past 16-byte alignment (layout "shifted": the forward then takes
# its CUDA-core kernel, the backward reads them as they are)
G2T = (1, 16, 8, 8192, 256)
SC2 = (2, 24, 2, 4096, 128)
MLA_T = (1, 128, 128, 4096, 192)
TC, CC = "tensor_cores", "cuda_cores"
FLASH_BWD_CASES = [
    flash_case(f"gemma2 global {G2T}", G2T, "bfloat16", layout="bshd",
               route=TC, causal=True, cap=50.0),
    flash_case(f"gemma2 local {G2T} scores x16", G2T, "bfloat16",
               layout="bshd", q_mul=16.0,
               faults=("no_cap_grad", "one_head", "no_delta", "no_window"),
               route=TC, causal=True, window=4096, cap=50.0),
    flash_case(f"starcoder2 {SC2}", SC2, "bfloat16", layout="bshd",
               route=TC, causal=True),
    flash_case(f"hubert {HUBERT}", HUBERT, "bfloat16", layout="bshd",
               route=TC, causal=False),
    flash_case(f"mla {MLA_T} dv {MLA_DV}", MLA_T, "bfloat16", layout="mla",
               dv=MLA_DV, route=TC, causal=True,
               scale=1.0 / math.sqrt(MLA_T[4])),
    flash_case(f"hubert {HUBERT}", HUBERT, "float32", layout="bshd",
               route=CC, causal=False),
    flash_case(f"starcoder2 {SC2} misaligned", SC2, "bfloat16",
               layout="shifted", route=CC, causal=True),
    # the fp32 card-vs-CPU steps' route at starcoder2's and MLA's training
    # shapes (causal: the rows that see few keys are where dq cancels)
    flash_case(f"starcoder2 {SC2}", SC2, "float32", layout="bshd",
               route=CC, causal=True),
    flash_case(f"mla {MLA_T} dv {MLA_DV}", MLA_T, "float32", layout="mla",
               dv=MLA_DV, route=CC, causal=True,
               scale=1.0 / math.sqrt(MLA_T[4])),
]
# per row of each gradient, the forward's bounds (FLASH_ROW_TOL) of the
# row's largest value — but no smaller than 2^-8 of the gradient's largest:
# dq's row at a query that sees few keys cancels (dP - delta, with o the
# p-weighted sum of v), and both sides' round-off scales with the products
# summed, not with the row's result
FLASH_BWD_ROW_FLOOR = 2.0 ** -8
# the forward's lse against the plain log-sum-exp of the same inputs:
# fp32 sums in other orders (and ex2.approx, 2^-22, on the tensor cores)
FLASH_LSE_TOL = 1e-4


def grad_row_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over rows of max|got - want| / max(max|want row|, floor·max|want|)."""
    got, want = got.float(), want.float()
    den = want.abs().amax(-1).clamp_min(FLASH_BWD_ROW_FLOOR * float(
        want.abs().max())).clamp_min(torch.finfo(torch.float32).tiny)
    return float(((got - want).abs().amax(-1) / den).max())


def flash_bwd_inputs(case: dict, seed: int):
    """``flash_inputs`` (layouts "bhsd", "bshd", "mla"; "shifted": bhsd
    copies 4 elements past 16-byte alignment) and dO [B,H,S,Dv] in the
    case's dtype, laid out as the layer's grad of o ([B,S,H,Dv] storage)."""
    q, k, v = flash_inputs(case, seed)
    B, H, _, S, _ = case["shape"]
    gen = torch.Generator(device=DEV).manual_seed(seed + 1)
    do = torch.randn((B, S, H, v.shape[-1]), device=DEV, generator=gen
                     ).to(q.dtype).transpose(1, 2)
    return q, k, v, do


def plain_by_heads(fn, q, k, *rest, heads: int = 16):
    """``fn`` (a plain version over q's heads and k's kv heads) over slices
    of whole groups of at most ``heads`` query heads, concatenated on the
    head axis: the same function with its [B,h,S,S] scores bounded."""
    KV = k.shape[1]
    G = q.shape[1] // KV
    step = max(1, heads // G)
    outs = []
    for a in range(0, KV, step):
        b = min(a + step, KV)
        outs.append(fn(q[:, a * G:b * G], k[:, a:b], *(
            t[:, a * G:b * G] if t.shape[1] == q.shape[1] else t[:, a:b]
            for t in rest)))
    if isinstance(outs[0], torch.Tensor):
        return torch.cat(outs, dim=1)
    return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))


def plain_backward(q, k, v, o, lse, do, kw, fault=None, mirror=False,
                   split=False):
    """The plain backward (``mirror``: the tensor-core route's CPU mirror,
    dS rounded to bf16 where it meets Q and K; ``split``: the fp32 mma.sync
    route's, every product as TF32 splits) over slices of heads."""
    from repro_torch.kernels.flash_attention import ref

    fn = ref.attention_backward_tc_reference if mirror else \
        ref.attention_backward_split_reference if split else \
        ref.attention_backward_reference
    return plain_by_heads(
        lambda q_, k_, v_, o_, l_, d_: fn(q_, k_, v_, o_, l_, d_, fault=fault,
                                          **kw), q, k, v, o, lse, do,
        heads=4 if split else 16)


def flash_bwd_bound_ms(shape, kw, dtype, dv=None) -> tuple[float, str]:
    """Least time for the gradient: q, k, v, o, dO and lse read once and
    dq, dk, dv written once at the HBM rate, against 2·B·H·(3D + 2Dv)
    operations per unmasked pair (S recomputed, dP, dV, dQ, dK) at the
    peak rate for the dtype (bf16 tensor cores; fp32 as three TF32
    products each)."""
    B, H, KV, S, D = shape
    dv = dv or D
    el = 2 if dtype == "bfloat16" else 4
    n_bytes = el * (2 * B * H * S * D + 2 * B * KV * S * (D + dv)
                    + 2 * B * H * S * dv) + 4 * B * H * S
    ops = 2 * B * H * (3 * D + 2 * dv) * attended_pairs(
        S, kw.get("causal", True), kw.get("window"))
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ms(ops, dtype)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_bwd_launch_ms(fn, calls: int = 3) -> dict:
    """Each backward launch's mean device time (ms) over ``calls`` calls
    (torch.profiler, CUDA activity), by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"flash_bwd_\w+(<[^>]*>)?", e.key)
        if e.device_type == DeviceType.CUDA and m:
            out[m.group(0)] = e.self_device_time_total / e.count / 1e3
    return out


def library_backward(q, k, v, do, kw):
    """The backward alone of one PyTorch call computing the same function
    (SDPA where there is no softcap and no window; compiled flex_attention
    otherwise): its forward is run once, and the returned callable runs
    its backward on ``do``.  A yardstick only; the port never calls it."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    if kw.get("cap") is None and kw.get("window") is None:
        call = "scaled_dot_product_attention backward"
        out = torch.nn.functional.scaled_dot_product_attention(
            *leaves, is_causal=kw.get("causal", True), scale=kw.get("scale"),
            enable_gqa=True)
    else:
        call = "flex_attention (compiled) backward"
        out = flex_library(*leaves, kw)()
    return call, lambda: torch.autograd.grad(out, leaves, do,
                                             retain_graph=True)


def flash_backward_phase(seed: int) -> dict:
    """Each case: the forward kernel with its lse (held to the plain
    log-sum-exp), the backward's route (the case's, by ``backward_route``
    and by the route counters), one backward call (three launches; held row
    by row to the plain backward on the same o and lse and, on the tensor
    cores, to the mirror), a second call bitwise equal, the planted faults
    failing the row check (against the mirror on the tensor cores); times
    of a call alone (CUDA graph), per call with the L2 flushed and per
    launch, of the plain backward and of the library's backward; both
    routes' registers and spills at each head dim, none spilling."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    # each launch's time first, for every case, before flex_attention's
    # backward is compiled; a profile of these launches can still come back
    # without them (every other one did, on the H100), so up to three tries
    launch_ms = {}
    for n, case in enumerate(FLASH_BWD_CASES):
        q, k, v, do = flash_bwd_inputs(case, seed + 100 + n)
        o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True,
                                         **case["kw"])
        for _ in range(3):
            launch_ms[n] = flash_bwd_launch_ms(
                lambda: fa.flash_attention_backward_cuda(q, k, v, o, lse, do,
                                                         **case["kw"]))
            if launch_ms[n]:
                break
        del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    results = {}
    for n, case in enumerate(FLASH_BWD_CASES):
        name, shape, kw, dtype = (case[x] for x in ("name", "shape", "kw",
                                                     "dtype"))
        q, k, v, do = flash_bwd_inputs(case, seed + 100 + n)
        o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        want_lse = plain_by_heads(
            lambda q_, k_: ref.attention_lse_reference(q_, k_, **kw), q, k)
        lse_err = float((lse - want_lse).abs().max())
        if not torch.allclose(lse, want_lse, atol=FLASH_LSE_TOL, rtol=1e-5):
            raise AssertionError(f"flash backward {name} {dtype}: lse differs "
                                 f"from the plain version by {lse_err}")
        del want_lse

        def call():
            return fa.flash_attention_backward_cuda(q, k, v, o, lse, do, **kw)
        route = fa.backward_route(q, k, v, o, do)
        if route != case["route"]:
            raise AssertionError(f"flash backward {name} {dtype}: route "
                                 f"{route}, expected {case['route']}")
        tc = route == "tensor_cores"

        def counts():
            return (fa.BACKWARD_LAUNCHES, fa.BACKWARD_CALL_LAUNCHES,
                    fa.BACKWARD_TENSOR_CORE_LAUNCHES,
                    fa.BACKWARD_CUDA_CORE_LAUNCHES)
        before = counts()
        got = call()
        moved = tuple(a - b for a, b in zip(counts(), before))
        if moved != (1, fa.backward_plan(q.dtype, shape[4], v.shape[-1],
                                         route).launches, int(tc), int(not tc)):
            raise AssertionError(f"flash backward {name}: launches {moved}, "
                                 f"expected one {route} call of three")
        again = call()
        repeat = all(bitwise_equal(a, b) for a, b in zip(got, again))
        del again
        if not repeat:
            raise AssertionError(f"flash backward {name}: two calls differ")
        want = plain_backward(q, k, v, o, lse, do, kw)
        torch.cuda.synchronize()
        tol = FLASH_ROW_TOL[dtype]
        errs, abs_errs, mirror_errs = {}, {}, {}
        for gname, g, w, t in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
            if g.shape != t.shape or g.dtype != t.dtype or \
                    not bool(torch.isfinite(g).all()):
                raise AssertionError(f"flash backward {name}: {gname} "
                                     f"{g.dtype} {tuple(g.shape)} not finite "
                                     f"or not shaped as its input")
            errs[gname] = grad_row_err(g, w)
            abs_errs[gname] = float((g.float() - w.float()).abs().max())
        del want
        if tc or dtype == "float32":
            mirror = plain_backward(q, k, v, o, lse, do, kw, mirror=tc,
                                    split=not tc)
            mirror_errs = {gname: grad_row_err(g, w) for gname, g, w in
                           zip(("dq", "dk", "dv"), got, mirror)}
            del mirror
        if not max([*errs.values(), *mirror_errs.values()]) <= tol:
            raise AssertionError(f"flash backward {name} {dtype}: row errors "
                                 f"{errs}, against the mirror {mirror_errs} "
                                 f"(tolerance {tol})")
        fault_errs = {}
        for fault in case["faults"]:
            wrong = plain_backward(q, k, v, o, lse, do, kw, fault=fault,
                                   mirror=tc)
            fault_errs[fault] = max(grad_row_err(g, w)
                                    for g, w in zip(got, wrong))
            del wrong
            if not fault_errs[fault] > tol:
                raise AssertionError(f"flash backward {name}: the row check "
                                     f"cannot tell the kernel from the plain "
                                     f"backward with {fault} "
                                     f"({fault_errs[fault]})")
        del got
        torch.cuda.empty_cache()
        big = shape[0] * shape[1] * shape[3] ** 2 >= 16 * 8192 * 4096
        ms = timed_ms(call, 3 if big else 10, flush)
        alone = kernel_alone_ms(call, 3 if big else 10)
        plain = timed_ms(lambda: plain_backward(q, k, v, o, lse, do, kw),
                         1 if big else 3, flush)
        library = library_error = lib_call = None
        try:
            lib_call, lib = library_backward(q, k, v, do, kw)
            library = timed_ms(lib, 3 if big else 10, flush)
            del lib
        except Exception as e:        # the yardstick only: recorded
            library_error = f"{type(e).__name__}: {e}"[:300]
        b, by = flash_bwd_bound_ms(shape, kw, dtype, case["dv"])
        key = f"{name} {dtype}"
        results[key] = dict(
            shape=list(shape), dv=case["dv"] or shape[4], options=kw,
            dtype=dtype, layout=case["layout"], q_mul=case["q_mul"],
            route=route, row_rel_err=errs, mirror_row_rel_err=mirror_errs,
            row_tol=tol, max_abs_err=max(abs_errs.values()),
            abs_err=abs_errs, lse_max_abs_err=lse_err, bitwise_repeat=repeat,
            fault_row_rel_err=fault_errs, ms=ms, alone_ms=alone,
            launch_ms=launch_ms[n], plain_ms=plain, bound_ms=b, bound_by=by,
            executed_over_needed=fa.backward_executed_ops(
                q.dtype, shape[4], case["dv"] or shape[4], route) / (
                2 * (3 * shape[4] + 2 * (case["dv"] or shape[4]))),
            library=lib_call, library_ms=library, library_error=library_error)
        lib_txt = (f"{lib_call} {library:.6f} ms" if library is not None
                   else f"raised {library_error}")
        log(f"kernel flash backward {key} {kw} {case['layout']}"
            + (f" q x{case['q_mul']:g}" if case["q_mul"] != 1.0 else "")
            + f" ({route}): row err "
            + ", ".join(f"{g} {e:.3e}" for g, e in errs.items())
            + "".join(f"; mirror {g} {e:.3e}" for g, e in mirror_errs.items())
            + f" (within {tol:.4g}), lse err {lse_err:.3e}, bitwise repeat "
            f"{repeat}"
            + "".join(f"; {f} {e:.3e}" for f, e in fault_errs.items())
            + f"; {ms:.6f} ms a call, {alone:.6f} ms alone, plain "
            f"{plain:.6f} ms, bound {b:.6f} ms ({by}), library {lib_txt}")
        log(f"kernel flash backward {key} per launch: " + ", ".join(
            f"{kn} {t:.6f} ms" for kn, t in launch_ms[n].items()))
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    info = {}
    pairs = {80: 80, 128: 128, 192: 128, 256: 256}
    for dtype, route in ((torch.bfloat16, TC), (torch.bfloat16, CC),
                         (torch.float32, CC)):
        for D, dv in pairs.items():
            dname = str(dtype).removeprefix("torch.")
            info[f"{dname} D {D} Dv {dv} {route}"] = r = \
                fa.backward_kernel_info(dtype, D, dv, route=route)
            plan = fa.backward_plan(dtype, D, dv, route=route)
            fields = ("route", "rows", "keys", "smem_bytes", "dq_rows",
                      "dq_smem_bytes", "dq_stages")
            if tuple(r[f] for f in fields) != \
                    tuple(getattr(plan, f) for f in fields):
                raise AssertionError(f"flash backward plan {plan} differs "
                                     f"from the card's {r}")
            log(f"kernel flash backward {dname} D {D} Dv {dv} ({route}): "
                f"{r['keys']} keys a dK/dV block, {r['smem_bytes']} / "
                f"{r['dq_smem_bytes']} shared bytes (dK/dV / dQ); " + ", ".join(
                    f"{kn} {r['registers'][kn]} registers "
                    f"{r['local_bytes'][kn]} spill bytes"
                    for kn in fa.BWD_KERNELS))
            if any(r["local_bytes"].values()):
                raise AssertionError(f"flash backward {dname} D {D} Dv {dv} "
                                     f"({route}) spills: {r}")
    results["kernel_info"] = info
    torch.cuda.empty_cache()
    return results


# ------------------ training the attention configs ----------------------- #

# (arch, changes to the published config, batch, tokens or frames a
# sequence, what the changes are): gemma2-9b cut to one block (a local and
# a global layer) at 8192 tokens, so its window of 4096 bites; starcoder2-3b
# and hubert-xlarge whole; deepseek-v3 cut to its first dense layer and the
# MTP block (one MoE layer alone is about 11.5 B params, 184 GB of training
# state).  gemma2 and deepseek-v3 train fp32 master params under bf16
# compute; starcoder2 and hubert keep their published bf16 params: their
# MLP's output bias is a 1-D leaf, which the mixed-precision policy keeps
# in the param dtype, so fp32 params would lift the residual stream to
# fp32 from the first layer on (the JAX package's block scan refuses that
# change of its carry's dtype)
ATTN_TRAIN = [
    ("gemma2-9b", dict(n_layers=2, param_dtype="float32"), 1, 8192,
     ["n_layers 42 -> 2 (one block: a local and a global layer)",
      "param_dtype bfloat16 -> float32 (fp32 master params, bf16 compute)"]),
    ("starcoder2-3b", {}, 2, 4096, []),
    ("hubert-xlarge", {}, 8, 1500, []),
    ("deepseek-v3-671b", dict(n_layers=1, first_dense_layers=1,
                              param_dtype="float32"), 1, 4096,
     ["n_layers 61 -> 1 and first_dense_layers 3 -> 1: the first dense "
      "layer and the MTP block, no MoE layer",
      "param_dtype bfloat16 -> float32 (fp32 master params, bf16 compute)"]),
]
ATTN_TRAIN_STEPS = 4
PLAIN_HASH_PIECE = 1 << 24          # lanes of a piece of the plain hash


def plain_hash(t: torch.Tensor) -> int:
    """The plain hash (``checksum/ref.py``) of ``t`` on its device, over
    pieces of PLAIN_HASH_PIECE lanes combined as the hash is blockwise
    combinable: h(x) = Σ_c h(piece_c)·r^(c·L) mod 2^32 (memory bounded: a
    grad leaf of gemma2-9b's embedding is 0.9 G lanes)."""
    from repro_torch.kernels.checksum import ref

    lanes = ref.as_words(t).reshape(-1)
    total = 0
    for c, i in enumerate(range(0, lanes.numel(), PLAIN_HASH_PIECE)):
        h = int(ref.checksum_lanes(lanes[i:i + PLAIN_HASH_PIECE]))
        total += h * pow(ref.R, c * PLAIN_HASH_PIECE, 1 << 32)
    return total & ref.MASK


def check_integrity(what: str, metrics, grads) -> None:
    """The step's integrity record equals the plain hash of each grad."""
    from repro_torch.tree import leaf_paths

    want = [plain_hash(g) for _, g in leaf_paths(grads)]
    got = metrics["integrity"].tolist()
    if got != want:
        raise AssertionError(f"{what}: integrity {got} is not the plain hash "
                             f"of the grads {want}")


def zero_bwd_counts() -> None:
    from repro_torch.kernels.flash_attention import flash_attention as fa

    zero_flash_counts()
    fa.BACKWARD_LAUNCHES = fa.BACKWARD_CALL_LAUNCHES = 0
    fa.BACKWARD_TENSOR_CORE_LAUNCHES = fa.BACKWARD_CUDA_CORE_LAUNCHES = 0
    fa.BACKWARD_DO_COPIES = 0


def bwd_counts() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention as fa

    return dict(flash_counts(), backward=fa.BACKWARD_LAUNCHES,
                backward_tensor_cores=fa.BACKWARD_TENSOR_CORE_LAUNCHES,
                backward_cuda_cores=fa.BACKWARD_CUDA_CORE_LAUNCHES,
                backward_kernels=fa.BACKWARD_CALL_LAUNCHES,
                do_copies=fa.BACKWARD_DO_COPIES)


def attention_layers(cfg) -> tuple[int, int]:
    """(attention layers inside the blocks, which run their forward twice a
    step under block remat; those outside: the dense prologue, the MTP
    block)."""
    inside = cfg.n_blocks * sum(k.mixer == "attn" for k in cfg.block_pattern())
    return inside, cfg.first_dense_layers + cfg.mtp_depth


def journaled_step(state, batch, cfg, opt):
    """``train_step`` with the journal and the state donated, timed; its
    integrity held to the plain hash of its grads.  -> (state, loss, ms)."""
    from repro_torch.train import step as S

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grads, metrics = S.grads_and_metrics(state["params"], batch, cfg)
    state, metrics = S.apply_step(state, grads, metrics, opt, journal=True,
                                  donate=True)
    loss = float(metrics["loss"])
    ms = (time.perf_counter() - t0) * 1e3
    check_integrity(f"{cfg.name} step {int(state['step'])}", metrics, grads)
    return state, loss, ms


def profiled_attention_step(state, batch, cfg, opt):
    """One step as ``train_step`` runs it (state donated, journaled), with
    the flash launches read after the forward and after the backward and
    the hash launches after the update.  -> (state, counts, metrics,
    grads)."""
    from repro_torch.models import model as M
    from repro_torch.train import step as S
    from repro_torch.tree import leaf_paths, map_with_path

    zero_bwd_counts()
    zero_hash_counts()
    leaves = {n: t.detach().requires_grad_(True)
              for n, t in leaf_paths(state["params"])}
    loss, metrics = M.forward_train(
        map_with_path(lambda n, _: leaves[n], state["params"]), cfg, batch)
    forward = bwd_counts()
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    backward = bwd_counts()
    by_name = {n: torch.zeros_like(t) if g is None else g     # empty leaves
               for (n, t), g in zip(leaves.items(), grads)}
    del leaves, loss
    grads = map_with_path(lambda n, _: by_name[n], state["params"])
    state, metrics = S.apply_step(
        state, grads, {k: v.detach() for k, v in metrics.items()}, opt,
        journal=True, donate=True)
    torch.cuda.synchronize()
    return state, dict(
        flash_forward=forward["all"],
        flash_recompute=backward["all"] - forward["all"],
        flash_tensor_core=backward["tensor_cores"],
        flash_backward=backward["backward"],
        flash_backward_tensor_core=backward["backward_tensor_cores"],
        flash_backward_kernels=backward["backward_kernels"],
        do_copies=backward["do_copies"], hash=hash_counts(),
        loss=float(metrics["loss"])), metrics, grads


def attention_train_phase(arch: str, seed: int, card: str) -> dict:
    """``arch`` at its published widths (cut in depth as ATTN_TRAIN says),
    bf16 compute (over fp32 master params where ATTN_TRAIN says), AdamW at
    TRAIN_OPT with a peak rate of TRAIN_LR and the state donated, synthetic data from --seed: a step, a profiled step (the flash
    forward launches — twice a block's attention layer under remat — and
    the backward calls held to what the config implies, all forward
    launches on the tensor cores), then ATTN_TRAIN_STEPS steps on one batch
    in which the loss must fall, every step's integrity equal to the plain
    hash of its grads; then the grads of one state taken twice, bitwise
    equal.  The batch halves while the peak passes TRAIN_PEAK_CUT_GB."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.launch.train import check_trainable
    from repro_torch.optim import OptConfig
    from repro_torch.train import step as S
    from repro_torch.tree import leaf_paths

    _, cut, batch, seq, cuts = next(a for a in ATTN_TRAIN if a[0] == arch)
    cfg = replace(get_config(arch), **cut)
    check_trainable(cfg, DEV, seq)
    opt = OptConfig(**dict(TRAIN_OPT, lr=TRAIN_LR))
    reduced = [*cuts, "weights random from --seed (init_params)",
               "synthetic batches (SyntheticDataset)"]
    inside, outside = attention_layers(cfg)
    # one hash launch a grad leaf that holds anything (deepseek-v3's cut
    # has no block: its stacked block leaves are empty)
    n_leaves = sum(math.prod(s.shape) > 0 for _, s in leaf_paths(
        S.train_state_specs(cfg, opt)["params"]))
    out: dict = dict(params=cfg.param_count())
    while True:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        data = SyntheticDataset(cfg, DataConfig(batch=batch, seq_len=seq,
                                                seed=seed))
        state = S.init_train_state(
            cfg, opt, torch.Generator(device=DEV).manual_seed(seed + 29), DEV)
        state, first_loss, _ = journaled_step(state, data.tensors_at(0, DEV),
                                              cfg, opt)
        b1 = data.tensors_at(1, DEV)
        (state, counts, metrics, grads), prof = device_window(
            lambda: profiled_attention_step(state, b1, cfg, opt))
        check_integrity(f"{arch} profiled step", metrics, grads)
        del grads, metrics
        peak = torch.cuda.max_memory_allocated() / 1e9
        if peak <= TRAIN_PEAK_CUT_GB or batch == 1:
            break
        reduced.append(f"batch {batch} -> {batch // 2}: peak {peak:.3f} GB > "
                       f"{TRAIN_PEAK_CUT_GB} GB")
        batch //= 2
        del state, b1
    out.update(describe(cfg, reduced, card))
    want = dict(flash_forward=inside + outside, flash_recompute=inside,
                flash_tensor_core=2 * inside + outside,
                flash_backward=inside + outside,
                flash_backward_tensor_core=inside + outside,
                flash_backward_kernels=3 * (inside + outside))
    got = {k: counts[k] for k in want}
    if got != want or counts["hash"]["launches"] != n_leaves:
        raise AssertionError(f"{arch} profiled step's launches {counts}: "
                             f"expected {want} and {n_leaves} hash launches")
    tokens = batch * seq
    out["profiled_step"] = dict(counts, profile=prof,
                                step_ms=prof["wall_ms"],
                                tokens_per_s=tokens / prof["wall_ms"] * 1e3,
                                peak_memory_gb=peak, batch=batch, seq=seq)
    log(f"{arch} train profiled step ({batch} x {seq}, {card}): "
        f"{prof['wall_ms']:.3f} ms ({tokens / prof['wall_ms'] * 1e3:.1f} "
        f"tokens/s), peak device memory {peak:.3f} GB; flash launches "
        f"{counts['flash_forward']} forward + {counts['flash_recompute']} "
        f"remat (all {counts['flash_tensor_core']} on the tensor cores) + "
        f"{counts['flash_backward']} backward calls "
        f"({counts['flash_backward_tensor_core']} on the tensor cores) "
        f"({counts['flash_backward_kernels']} kernels, {counts['do_copies']} "
        f"dO copies); hash launches {counts['hash']}")
    log_profile(f"{arch} train step", prof)

    # the loss on one batch over ATTN_TRAIN_STEPS steps
    b2 = data.tensors_at(2, DEV)
    zero_bwd_counts()
    losses, ms = [], []
    for _ in range(ATTN_TRAIN_STEPS):
        state, loss, t = journaled_step(state, b2, cfg, opt)
        losses.append(loss)
        ms.append(t)
    main = bwd_counts()
    n = ATTN_TRAIN_STEPS
    if (main["all"], main["tensor_cores"], main["backward"],
            main["backward_tensor_cores"]) != \
            (n * (2 * inside + outside), n * (2 * inside + outside),
             n * (inside + outside), n * (inside + outside)):
        raise AssertionError(f"{arch} steps' flash launches {main}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{arch}: the loss did not fall over "
                             f"{n} steps on one batch: {losses}")

    # one state's grads twice: bitwise equal
    g1 = [g.cpu() for _, g in leaf_paths(S.grads_and_metrics(
        state["params"], b2, cfg)[0])]
    g2, _ = S.grads_and_metrics(state["params"], b2, cfg)
    repeat = all(torch.equal(a, b.cpu()) for a, (_, b) in zip(
        g1, leaf_paths(g2)))
    del g1, g2
    if not repeat:
        raise AssertionError(f"{arch}: two grads of one state differ")
    med = float(np.median(ms))
    out.update(losses_first_steps=[first_loss, counts["loss"]],
               losses=losses, step_ms=ms, step_ms_median=med,
               tokens_per_s=tokens / med * 1e3, integrity_steps_checked=n + 2,
               grads_bitwise_repeat=repeat, main_path_counts=main,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"{arch} train: {n} steps of {batch} x {seq} on one batch, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} ({', '.join(f'{x:.4f}' for x in losses)}); "
        f"median step {med:.3f} ms ({out['tokens_per_s']:.1f} tokens/s); "
        f"integrity equal to the plain hash at {n + 2} steps; a state's grads "
        f"twice bitwise equal; flash launches {main}; peak "
        f"{out['peak_memory_gb']:.3f} GB")
    del state, b1, b2, data
    torch.cuda.empty_cache()
    return out


# (arch, cut at full width, what the cut is, a planted fault of the
# backward the grads must fail on[, the optimizer]): gemma2-9b's two
# layers with a window of 128 (it bites at 256 tokens), dk and dv from one
# head of each group; deepseek-v3's dense layer and MTP block, the
# backward without the causal mask; hubert-xlarge's two layers, the
# backward with one; qwen2-7b's and command-r's one layer, one head's dk
# and dv; moonshot's one layer (one head a group), no causal mask.  The
# last three took two layers until the checkpointing trainer joined the
# script; one each keeps it inside its time limit
ATTN_CPU = [
    ("gemma2-9b", dict(n_layers=2, sliding_window=128),
     ["n_layers 42 -> 2", "sliding_window 4096 -> 128 (bites at 256 tokens)"],
     "one_head"),
    ("deepseek-v3-671b", dict(n_layers=1, first_dense_layers=1),
     ["n_layers 61 -> 1, first_dense_layers 3 -> 1 (with the MTP block)"],
     "causal dropped"),
    ("hubert-xlarge", dict(n_layers=2), ["n_layers 48 -> 2"], "causal added"),
    ("qwen2-7b", dict(n_layers=1), ["n_layers 28 -> 1"], "one_head",
     "adafactor"),
    ("command-r-35b", dict(n_layers=1), ["n_layers 40 -> 1"], "one_head"),
    ("moonshot-v1-16b-a3b", dict(n_layers=1), ["n_layers 48 -> 1"],
     "causal dropped"),
]
# tokens or frames of the step (cut from 512 when three configs joined, to
# keep the script inside its time limit)
ATTN_CPU_TOKENS = 256
# Adafactor's pieces in the card-vs-CPU step (both sides): qwen2-7b's
# stacked MLP leaves then split into 6 rows of [2, 18944] a piece, so the
# planted fault (the update's RMS clip taken per piece) bites
ATTN_CPU_PIECE = 1 << 18


@contextmanager
def planted_backward(fault: str):
    """The flash backward of the autograd Function made wrong with the real
    kernel: "one_head" takes dk and dv from the first head of each group
    (dq stays right), "causal dropped" / "causal added" flips the
    backward's causal mask."""
    from repro_torch.kernels.flash_attention import ops

    real = ops.flash_attention_backward_cuda

    def wrong(q, k, v, o, lse, do, **kw):
        if fault == "one_head":
            G = q.shape[1] // k.shape[1]
            dq, _, _ = real(q, k, v, o, lse, do, **kw)
            _, dk, dv = real(q[:, ::G], k, v, o[:, ::G],
                             lse[:, ::G].contiguous(), do[:, ::G], **kw)
            return dq, dk, dv
        return real(q, k, v, o, lse, do,
                    **dict(kw, causal=fault == "causal added"))
    ops.flash_attention_backward_cuda = wrong
    try:
        yield
    finally:
        ops.flash_attention_backward_cuda = real


def attention_card_vs_cpu_phase(arch: str, seed: int) -> dict:
    """``arch`` at full width cut as ATTN_CPU says, fp32: the grads of 1 x
    ATTN_CPU_TOKENS tokens or frames from the same state on the card (the
    flash kernels on the CUDA cores, then one donated AdamW step, Adafactor
    in pieces of ATTN_CPU_PIECE where ATTN_CPU says) and on the CPU (the
    port's plain strategies under autograd): loss within 1e-5 relative and every grad leaf within
    TRAIN_CPU_TOL of its largest magnitude; the card's grads with the
    planted backward fault must move past that.  An Adafactor update from
    the CPU's grads is held to the CPU's too (``step_errs``: params and
    moments), and with the RMS clip taken per piece it must move past
    that."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.optim import OptConfig

    _, cut, cuts, fault, *name = next(a for a in ATTN_CPU if a[0] == arch)
    cfg = replace(get_config(arch), param_dtype="float32",
                  compute_dtype="float32", **cut)
    opt = OptConfig(**dict(TRAIN_OPT, name=name[0] if name else "adamw"))
    if opt.name == "adafactor":
        from repro_torch.optim import optimizer
        piece, optimizer.PIECE = optimizer.PIECE, ATTN_CPU_PIECE
        try:
            return attention_card_vs_cpu_step(arch, cfg, opt, cuts, fault,
                                              seed)
        finally:
            optimizer.PIECE = piece
    return attention_card_vs_cpu_step(arch, cfg, opt, cuts, fault, seed)


@contextmanager
def rms_clip_per_piece():
    """A planted fault: Adafactor's update clipped by each piece's own RMS
    instead of the whole leaf's."""
    from repro_torch.optim import optimizer

    real = optimizer._clip_rms
    optimizer._clip_rms = lambda sums, sizes: [
        torch.sqrt(x / n + 1e-30) for x, n in zip(sums, sizes)]
    try:
        yield
    finally:
        optimizer._clip_rms = real


def step_errs(new_card, new_cpu, old_params) -> tuple[dict, dict]:
    """(each new param leaf's distance card vs CPU, each new moment
    leaf's) after updates from the same grads: moments as a share of the
    leaf's largest magnitude, params as TRAIN_CPU_TOL times a share of the
    leaf's largest update plus two fp32 spacings of its largest value
    (p - lr·u rounds to p's spacing)."""
    from repro_torch.tree import leaf_paths

    moment_err = {n: float((x.cpu() - y).abs().max())
                  / float(y.abs().max().clamp_min(1e-30))
                  for (n, x), (_, y) in zip(leaf_paths(new_card["opt"]),
                                            leaf_paths(new_cpu["opt"]))}
    param_err = {}
    old = dict(leaf_paths(old_params))
    for (n, pc), (_, pp) in zip(leaf_paths(new_card["params"]),
                                leaf_paths(new_cpu["params"])):
        upd = (pp - old[n]).abs().max()
        scale = TRAIN_CPU_TOL * upd + 2 * FP32_SPACING * pp.abs().max()
        param_err[n] = TRAIN_CPU_TOL * float((pc.cpu() - pp).abs().max()
                                             / scale.clamp_min(1e-30))
    return param_err, moment_err


def attention_card_vs_cpu_step(arch, cfg, opt, cuts, fault, seed) -> dict:
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.train import step as S
    from repro_torch.tree import leaf_paths, tree_map

    inside, outside = attention_layers(cfg)
    # drawn on the card (3.1 G values for deepseek-v3's cut), copied to the
    # host; each side's step donates its own copy
    card = S.init_train_state(cfg, opt, torch.Generator(
        device=DEV).manual_seed(seed + 31), DEV)
    card["step"] = torch.tensor(2, dtype=torch.int32, device=DEV)
    adafactor = opt.name == "adafactor"
    # the host takes the optimizer's step only where its update is compared
    host = tree_map(lambda t: t.to("cpu", copy=True),
                    card if adafactor else {"params": card["params"]})
    old = tree_map(lambda t: t.clone(), host["params"]) if adafactor \
        else None
    batch = SyntheticDataset(cfg, DataConfig(
        batch=1, seq_len=ATTN_CPU_TOKENS, seed=seed)).tensors_at(0, "cpu")
    t0 = time.perf_counter()
    g_tree, met = S.grads_and_metrics(host["params"], batch, cfg)
    if adafactor:
        S.apply_step(host, g_tree, met, opt, donate=True)
    cpu_s = time.perf_counter() - t0
    loss_cpu = float(met["loss"])
    g_cpu = dict(leaf_paths(g_tree))
    if not adafactor:
        del host, g_tree
    on_card = {k: v.to(DEV) for k, v in batch.items()}

    def leaf_errs(grads) -> dict:
        out = {}
        for n, g in leaf_paths(grads):
            want = g_cpu[n]
            if not want.numel():            # deepseek-v3's empty block leaves
                continue
            out[n] = float((g.cpu() - want).abs().max()) / max(
                float(want.abs().max()), 1e-30)
        return out
    with planted_backward(fault):
        g_fault, _ = S.grads_and_metrics(card["params"], on_card, cfg)
    fault_err = max(leaf_errs(g_fault).values())
    del g_fault
    zero_bwd_counts()
    g_card, met = S.grads_and_metrics(card["params"], on_card, cfg)
    counts = bwd_counts()
    opt_errs = {}
    if adafactor:
        # the update alone, card vs CPU: the CPU's grads on the card, so
        # that the two updates differ by the optimizer's arithmetic only
        # (Adafactor's update is linear in g, so the grads' own card-vs-CPU
        # distance, held above, would pass into it where a row or column
        # of a leaf is small)
        g_same = tree_map(lambda t: t.to(DEV), g_tree)
        with rms_clip_per_piece():
            wrong, _ = S.apply_step(card, g_same, met, opt)
        p_err, _ = step_errs(wrong, host, old)
        opt_errs["rms_clip_per_piece"] = max(p_err.values())
        del wrong
        S.apply_step(card, g_same, met, opt, donate=True)
        p_err, m_err = step_errs(card, host, old)
        opt_errs.update(params=max(p_err.values()),
                        moments=max(m_err.values()))
        del host, old, g_tree, g_same
    else:
        S.apply_step(card, g_card, met, opt, donate=True)
    if (counts["all"], counts["cuda_cores"], counts["backward"],
            counts["backward_cuda_cores"]) != \
            (2 * inside + outside, 2 * inside + outside, inside + outside,
             inside + outside):
        raise AssertionError(f"{arch} fp32 card step's flash launches "
                             f"{counts}: expected the CUDA-core forward and "
                             f"backward")
    errs = leaf_errs(g_card)
    loss_rel = abs(float(met["loss"]) - loss_cpu) / abs(loss_cpu)
    worst = max(errs, key=errs.get)
    log(f"{arch} train card vs cpu (fp32, {'; '.join(cuts)}, 1 x "
        f"{ATTN_CPU_TOKENS}): loss {float(met['loss']):.7f} / {loss_cpu:.7f} "
        f"({loss_rel:.3e} relative, tolerance 1e-5); worst grad leaf "
        f"{errs[worst]:.3e} ({worst}; tolerance {TRAIN_CPU_TOL}); with the "
        f"backward's {fault}: {fault_err:.3e}; CPU step {cpu_s:.3f} s; flash "
        f"launches {counts}; optimizer {opt.name}"
        + ("" if not adafactor else
           f" in pieces of {ATTN_CPU_PIECE}, from the CPU's grads: worst "
           f"param leaf {opt_errs['params']:.3e}, moment leaf "
           f"{opt_errs['moments']:.3e} (tolerance {TRAIN_CPU_TOL}); with the "
           f"RMS clip taken per piece {opt_errs['rms_clip_per_piece']:.3e}"))
    if not (loss_rel <= 1e-5 and errs[worst] <= TRAIN_CPU_TOL):
        raise AssertionError(f"{arch}: card and CPU train steps disagree: "
                             f"loss {loss_rel:.3e}, {worst} {errs[worst]}")
    if not fault_err > TRAIN_CPU_TOL:
        raise AssertionError(f"{arch}: the backward with {fault} passes the "
                             f"card-vs-CPU check ({fault_err})")
    if adafactor and not (opt_errs["params"] <= TRAIN_CPU_TOL and
                          opt_errs["moments"] <= TRAIN_CPU_TOL):
        raise AssertionError(f"{arch}: card and CPU Adafactor updates "
                             f"disagree: {opt_errs}")
    if adafactor and not opt_errs["rms_clip_per_piece"] > TRAIN_CPU_TOL:
        raise AssertionError(f"{arch}: an update clipped per piece passes "
                             f"the card-vs-CPU check: {opt_errs}")
    del card, g_card, g_cpu
    torch.cuda.empty_cache()
    return dict(reduced=cuts, loss_rel_err=loss_rel, worst_grad_leaf=worst,
                worst_grad_leaf_err=errs[worst], tol=TRAIN_CPU_TOL,
                planted_fault=fault, planted_fault_grad_err=fault_err,
                cpu_s=cpu_s, flash_counts=counts, optimizer=opt.name,
                optimizer_errs=opt_errs)


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
    the device (kernel) ms, their ratio, the five kernels that took the
    most device time, and the device ms and launches of the flash
    backward's kernels (``flash_bwd`` in the name)).  Kernel times are the
    profiler's CUDA events only, so no op's time is counted twice."""
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
    bwd = [e for e in kernels if "flash_bwd" in e.key]
    return result, dict(
        wall_ms=wall_ms, device_ms=device_ms, busy_share=device_ms / wall_ms,
        top_kernels=[dict(name=e.key[:80], ms=e.self_device_time_total / 1e3,
                          count=e.count) for e in top],
        flash_backward_ms=sum(e.self_device_time_total for e in bwd) / 1e3,
        flash_backward_launches=sum(e.count for e in bwd))


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

    zero_flash_counts()
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
    zero_flash_counts()
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
        log_profile(f"gemma2 {name}", out[f"{name}_profile"])
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


# ------------- deepseek-v3, hubert-xlarge and llava-next-34b -------------- #

def flash_counts() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention as fa

    return dict(all=fa.LAUNCHES, tensor_cores=fa.TENSOR_CORE_LAUNCHES,
                cuda_cores=fa.CUDA_CORE_LAUNCHES)


def zero_flash_counts() -> None:
    from repro_torch.kernels.flash_attention import flash_attention as fa

    fa.LAUNCHES = fa.TENSOR_CORE_LAUNCHES = fa.CUDA_CORE_LAUNCHES = 0


def expect_flash(counts: dict, n: int, route: str, what: str) -> None:
    other = "cuda_cores" if route == "tensor_cores" else "tensor_cores"
    if counts["all"] != n or counts[route] != n or counts[other]:
        raise AssertionError(f"{what}: flash launches {counts}, expected {n} "
                             f"on the {route} kernel")


def log_profile(what: str, w: dict) -> None:
    log(f"{what} under the profiler: wall {w['wall_ms']:.3f} ms, device "
        f"{w['device_ms']:.3f} ms (busy {w['busy_share']:.4f}); flash "
        f"backward {w['flash_backward_ms']:.3f} ms in "
        f"{w['flash_backward_launches']} launches; top: "
        + "; ".join(f"{k['name'][:48]} {k['ms']:.3f} ms x{k['count']}"
                    for k in w["top_kernels"]))


def describe(cfg, reduced: list, card: str) -> dict:
    """The configuration a path ran and every cut from the published one,
    printed beside the card line."""
    keys = ("n_layers", "d_model", "n_heads", "n_kv_heads",
            "resolved_head_dim", "d_ff", "vocab_size", "q_lora_rank",
            "kv_lora_rank", "qk_nope_dim", "qk_rope_dim", "v_head_dim",
            "n_experts", "n_shared_experts", "experts_per_token", "moe_d_ff",
            "first_dense_layers", "capacity_factor", "causal", "input_kind",
            "frontend_dim", "n_patches", "param_dtype", "compute_dtype")
    conf = {k: getattr(cfg, k) for k in keys}
    log(f"{cfg.name} config: {json.dumps(conf)}")
    log(f"{cfg.name} reduced: {json.dumps(reduced)}")
    log(f"{cfg.name} card: {card}")
    return dict(config=conf, reduced=reduced, card=card)


DS_BATCH, DS_PROMPT, DS_DECODE = 2, 4096, 32
DS_LAYERS = 4                      # the 3 dense-prologue layers + 1 MoE layer
DS_CUT = 512                       # teacher-forced: prefill 512, decode 4
# teacher-forced decode against a 516-token prefill, bf16, as a share of
# the largest |logit| at the four positions: the prefill attends per head
# through the flash kernel (fp32 P), the absorbed decode in the latent
# space (wkv_b folded into q and o, p rounded to bf16), so every layer
# rounds at other places.  A CPU rehearsal of this check in bf16 (4 layers:
# 3 dense + 1 MoE, d_model 1024 and 2048) differed by 1.2% of the largest
# logit (0.031-0.047 at logits up to 2.7-3.8, ≈ 3 bf16 spacings); 3% leaves
# a factor of 2.5, and a wrong decode moves logits by their spread (std
# ≈ 0.25 of the largest).
DS_TEACHER_REL_TOL = 3e-2
# Where a decode step routes a token to other experts than the prefill did,
# the check holds the decode to a prefill forced to the decode's experts,
# and only for a genuine near tie: at most DS_MAX_FLIPS of the 4 positions,
# each flip one expert swapped for the prefill's (K+1)-th, with the
# prefill's probability of the swapped-out expert above that of the
# swapped-in one by at most DS_FLIP_MARGIN (router probabilities are
# ≈ 1/256 = 3.9e-3).  Reading (H100, seed 0): one flip, at position 515,
# margin 1.15e-4; the run prints every position's K-th margin.
DS_MAX_FLIPS = 1
DS_FLIP_MARGIN = 1e-3


@contextmanager
def moe_routing(force=None):
    """Record each ``moe_ffn`` call's router probabilities [T,E] and top-k
    experts [T,K] (``layers.top_k`` wrapped) into the yielded list; with
    ``force`` {call: (rows, experts [n,K])}, route those rows of that call
    to those experts instead, with their probabilities as gates.  Harness
    only: the port's routing is untouched outside the block."""
    from repro_torch.models import layers as L

    real, calls = L.top_k, []

    def top_k(probs, k):
        gate, idx = real(probs, k)
        if len(calls) in (force or {}):
            rows, experts = force[len(calls)]
            idx = idx.clone()
            idx[rows] = experts
            gate = probs.gather(1, idx)
        calls.append((probs.detach().clone(), idx.detach().clone()))
        return gate, idx
    L.top_k = top_k
    try:
        yield calls
    finally:
        L.top_k = real


def routing_flips(pre_calls, dec_calls, rows):
    """Tokens that a decode step routes to other experts than the prefill
    did ({(call, row): the decode's experts}); for each, the prefill's
    view of the swap ({(call, row): dropped and added experts, the added
    ones' ranks in the prefill (K is the (K+1)-th), the prefill's margin
    p[dropped] - p[added]}); the prefill's K-th margin at every token
    ({(call, row): p of its K-th expert - p of its (K+1)-th}); and the
    largest difference between the two paths' router log-probabilities (a
    common shift removed) as a share of the prefill's log-probability
    spread: the router's inputs held to the logits' relative tolerance."""
    flips, swaps, kth, noise = {}, {}, {}, 0.0
    for call, (pp, pi) in enumerate(pre_calls):
        K = pi.shape[1]
        for j, row in enumerate(rows):
            dp, di = dec_calls[j][call]
            p = pp[row]
            lp, ld = p.clamp_min(1e-30).log(), dp[0].clamp_min(1e-30).log()
            delta = ld - lp
            noise = max(noise, float((delta - delta.median()).abs().max()
                                     / (lp.max() - lp.min())))
            order = p.argsort(descending=True).tolist()
            kth[(call, row)] = float(p[order[K - 1]] - p[order[K]])
            pre, dec = set(pi[row].tolist()), set(di[0].tolist())
            if pre != dec:
                flips[(call, row)] = di[0]
                dropped, added = sorted(pre - dec), sorted(dec - pre)
                swaps[(call, row)] = dict(
                    dropped=dropped, added=added,
                    added_ranks=[order.index(e) for e in added],
                    margin=float(p[dropped].max() - p[added].min()))
    return flips, swaps, kth, noise


def check_routing_flips(swaps: dict, K: int) -> None:
    """Raise unless every flip is a genuine near tie (DS_MAX_FLIPS,
    DS_FLIP_MARGIN): one expert swapped for the prefill's (K+1)-th, within
    the margin."""
    if len(swaps) > DS_MAX_FLIPS:
        raise AssertionError(f"deepseek-v3 teacher-forced decode: "
                             f"{len(swaps)} tokens routed to other experts "
                             f"(at most {DS_MAX_FLIPS}): {swaps}")
    for key, swap in swaps.items():
        if len(swap["dropped"]) != 1 or swap["added_ranks"] != [K] or \
                not swap["margin"] <= DS_FLIP_MARGIN:
            raise AssertionError(
                f"deepseek-v3 teacher-forced decode: token {key} routed to "
                f"other experts than a near tie explains (one expert swapped "
                f"for the prefill's rank {K}, margin at most "
                f"{DS_FLIP_MARGIN}): {swap}")


def deepseek_serving_phase(seed: int, card: str) -> dict:
    """deepseek-v3-671b at its published widths cut to 4 layers (the 3
    dense-prologue layers and 1 MoE layer), bf16, weights from --seed:
    prefill 2 x 4096 (one flash launch a layer, tensor cores, D 192 / Dv 128)
    and 32 greedy decode steps (absorbed MLA on the latent cache); the
    prefill again, bitwise equal; then a 512-token prefill and 4
    teacher-forced decode steps held against a 516-token prefill under
    the same expert routing, in a copy of the config that drops no
    token."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    published = get_config("deepseek-v3-671b")
    cfg = replace(published, n_layers=DS_LAYERS)
    dropless = published.n_experts / published.experts_per_token
    out = describe(cfg, [
        f"n_layers {published.n_layers} -> {cfg.n_layers}: the "
        f"{cfg.first_dense_layers} dense-prologue layers and 1 MoE layer (5 "
        f"layers' stacked expert leaf is 60.1 GB in fp32 at init)",
        "weights random from --seed (init_params), no checkpoint",
        f"teacher-forced check only: capacity_factor "
        f"{published.capacity_factor} -> {dropless:g} (= n_experts / "
        f"experts_per_token: C = T, so no token is dropped; a router near "
        f"tie may still route a decode step to other experts than the "
        f"prefill, which the check bounds and forces, see "
        f"DS_FLIP_MARGIN)"], card)
    B, P = DS_BATCH, DS_PROMPT
    T = P + DS_DECODE + 1
    width = cfg.kv_lora_rank + cfg.qk_rope_dim
    dqk = cfg.qk_nope_dim + cfg.qk_rope_dim
    out.update(
        param_count=cfg.param_count(),
        params_gb=cfg.param_count() * 2 / 1e9,
        latent_cache_bytes_per_layer=B * T * width * 2,
        per_head_kv_bytes_per_layer=B * T * cfg.n_heads
        * (dqk + cfg.v_head_dim) * 2)
    log(f"deepseek-v3 memory reckoned: params {out['params_gb']:.3f} GB "
        f"(bf16); latent cache {out['latent_cache_bytes_per_layer']} bytes a "
        f"layer ({B} x {T} x {width} bf16) in place of "
        f"{out['per_head_kv_bytes_per_layer']} bytes of per-head K/V ({B} x "
        f"{T} x {cfg.n_heads} x ({dqk} + {cfg.v_head_dim}) bf16)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.cast_params(M.init_params(
        cfg, torch.Generator(device=DEV).manual_seed(seed), device=DEV), cfg)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["init_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    prompts = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, P))).to(DEV)

    zero_flash_counts()
    res = serve.generate(params, cfg, prompts, DS_DECODE + 1)
    out["flash"] = flash_counts()
    expect_flash(out["flash"], cfg.n_layers, "tensor_cores",
                 "deepseek-v3 prefill + decode")
    logits = res.prefill_logits
    if tuple(logits.shape) != (B, P, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"deepseek-v3 prefill logits "
                             f"{tuple(logits.shape)} not finite or not [B,S,V]")
    toks = res.tokens
    if tuple(toks.shape) != (B, DS_DECODE + 1) or int(toks.min()) < 0 or \
            int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"decoded tokens {tuple(toks.shape)} out of range")
    # the same prefill again, under the profiler: the MoE combine adds in a
    # fixed order, so the logits must repeat bit for bit
    cache = M.init_cache(cfg, B, T, device=DEV)
    (again, _), out["prefill_profile"] = device_window(
        lambda: M.serve_step(params, cfg, {"tokens": prompts}, cache, 0))
    out["prefill_ms_warm"] = out["prefill_profile"]["wall_ms"]
    out["prefill_bitwise_repeat"] = bitwise_equal(again, logits)
    del again, cache
    out.update(
        prefill_ms=res.prefill_s * 1e3,
        prefill_tokens_per_s=B * P / res.prefill_s,
        decode_ms_per_step=res.decode_s * 1e3 / res.decode_steps,
        decode_tokens_per_s=B * res.decode_steps / res.decode_s,
        decode_steps=res.decode_steps,
        logits_abs_max=float(logits.abs().max().float()))
    log(f"deepseek-v3 init {out['init_s']:.3f} s (peak "
        f"{out['init_peak_gb']:.3f} GB); prefill {B} x {P} in "
        f"{out['prefill_ms']:.3f} ms cold, {out['prefill_ms_warm']:.3f} ms "
        f"warm; {out['flash']['all']} flash launches "
        f"({out['flash']['tensor_cores']} on the tensor cores, D {dqk} / Dv "
        f"{cfg.v_head_dim}); decode {res.decode_steps} steps, "
        f"{out['decode_ms_per_step']:.3f} ms/step "
        f"({out['decode_tokens_per_s']:.1f} tok/s); prefill repeated "
        f"bitwise: {out['prefill_bitwise_repeat']}")
    log_profile("deepseek-v3 warm prefill", out["prefill_profile"])
    if not out["prefill_bitwise_repeat"]:
        raise AssertionError("deepseek-v3: a second prefill of the same "
                             "prompts gave other logits")
    del logits, res
    torch.cuda.empty_cache()

    # Nothing is dropped, but a token whose K-th and (K+1)-th router
    # probabilities are nearly tied may route to other experts in the
    # decode than in the prefill: the two paths round differently (the
    # prefill's P is rounded to bf16 unnormalised inside the flash kernel,
    # the decode's p after normalising), and a swapped expert moves that
    # position's logits by their spread (on an H100 at seed 0, position
    # 515's K-th margin of 1.2e-4 moved its logits by 0.223, against a
    # tolerance of 0.14).  So the router's inputs are held to the same
    # relative tolerance as the logits, every flip must be a near tie
    # (check_routing_flips), and where the expert sets differ the prefill
    # is run again with the decode's experts at that token: every position
    # is then held to DS_TEACHER_REL_TOL under the same discrete routing.
    tf = replace(cfg, capacity_factor=dropless)
    one = prompts[:1, :DS_CUT + 4]
    rows = range(DS_CUT, DS_CUT + 4)
    zero_flash_counts()
    with moe_routing() as pre_calls:
        full, _ = M.serve_step(params, tf, {"tokens": one}, None, None)
    want = full[:, DS_CUT:DS_CUT + 4].float().clone()
    del full
    cache = M.init_cache(tf, 1, DS_CUT + 4, device=DEV)
    _, cache = M.serve_step(params, tf, {"tokens": one[:, :DS_CUT]}, cache, 0)
    expect_flash(flash_counts(), 2 * cfg.n_layers, "tensor_cores",
                 "deepseek-v3 teacher-forced prefills")
    steps, dec_calls = [], []
    for j in range(4):
        with moe_routing() as calls:
            step, cache = M.serve_step(
                params, tf, {"tokens": one[:, DS_CUT + j:DS_CUT + j + 1]},
                cache, DS_CUT + j)
        steps.append(step[:, 0].float())
        dec_calls.append(calls)
    flips, swaps, kth, router_noise = routing_flips(pre_calls, dec_calls,
                                                    rows)
    unforced = [float((steps[j] - want[:, j]).abs().max()) for j in range(4)]
    if flips:
        by_call = {}
        for (call, row), experts in flips.items():
            by_call.setdefault(call, []).append((row, experts))
        with moe_routing(force={c: (torch.tensor([r for r, _ in v]),
                                    torch.stack([e for _, e in v]))
                                for c, v in by_call.items()}):
            forced, _ = M.serve_step(params, tf, {"tokens": one}, None, None)
        want = forced[:, DS_CUT:DS_CUT + 4].float().clone()
        del forced
    diffs = [float((steps[j] - want[:, j]).abs().max()) for j in range(4)]
    scale = float(want.abs().max())
    out.update(teacher_forced_max_abs_diff=max(diffs),
               teacher_forced_unforced_diffs=unforced,
               teacher_forced_routing_flips={
                   row: swap for (call, row), swap in swaps.items()},
               teacher_forced_kth_margins={
                   row: m for (call, row), m in kth.items()},
               teacher_forced_router_rel_diff=router_noise,
               teacher_forced_logit_abs_max=scale,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"deepseek-v3 teacher-forced decode at {DS_CUT}..{DS_CUT + 3} "
        f"(capacity factor {dropless:g}): max abs diff {max(diffs):.4e} "
        f"against the {DS_CUT + 4}-token prefill's logits (tolerance "
        f"{DS_TEACHER_REL_TOL} of the largest, {scale:.4f}); router inputs "
        f"{router_noise:.4e} apart (tolerance {DS_TEACHER_REL_TOL}); "
        f"{len(swaps)} tokens routed to other experts in the decode (at most "
        f"{DS_MAX_FLIPS}), with the prefill's ranks of the added experts and "
        f"margin p[dropped] - p[added] (at most {DS_FLIP_MARGIN}): "
        f"{out['teacher_forced_routing_flips']}; the prefill's K-th margins "
        f"{out['teacher_forced_kth_margins']} (prefill run again with the "
        f"decode's experts there; without that {max(unforced):.4e}); peak "
        f"device memory {out['peak_memory_gb']:.3f} GB")
    check_routing_flips(swaps, cfg.experts_per_token)
    if not router_noise <= DS_TEACHER_REL_TOL:
        raise AssertionError(f"deepseek-v3 teacher-forced decode: router "
                             f"inputs {router_noise} apart")
    if not max(diffs) <= DS_TEACHER_REL_TOL * scale:
        raise AssertionError(f"deepseek-v3 teacher-forced decode diverges: "
                             f"{diffs}")
    del cache, prompts
    torch.cuda.empty_cache()
    out["moe_card_vs_cpu"] = moe_card_vs_cpu(params, cfg, seed)
    del params
    torch.cuda.empty_cache()
    return out


MOE_TOKENS = 256
# one full-width MoE FFN call, bf16, card against CPU, per token: max over
# the token's output of |card - cpu| / max |cpu|.  Both round h, the
# activation, the expert outputs and each of the K adds to bf16, in other
# accumulation orders; a CPU rehearsal (d_model 7168, 32 experts, top-8,
# 32 and 64 tokens, capacity 1.25 so that pairs drop) gave 5.3e-3 to 5.8e-3
# between bf16 products and fp32 products rounded to bf16 (2^-8 to 2^-7:
# one or two spacings of a row's largest value), and 0.38 to 1.15 for the
# same call at a capacity that drops nothing.  2^-5 leaves a factor of 5.
MOE_ROW_TOL = 2.0 ** -5


def moe_card_vs_cpu(params, cfg, seed: int) -> dict:
    """The served 4-layer model's MoE layer at full width (256 experts,
    top-8, 1 shared, capacity factor 1.25), bf16: ``moe_ffn`` on 256
    tokens of random hidden states on the card and on the CPU, held per
    token within MOE_ROW_TOL; some (token, expert) pairs must be dropped,
    and the same call at a capacity that drops none must move the output
    past the tolerance."""
    from dataclasses import replace

    from repro_torch.models import layers as L
    from repro_torch.tree import tree_map

    ffn = tree_map(lambda t: t[0], params["blocks"]["l0"]["ffn"])
    if "router" not in ffn:
        raise AssertionError("deepseek-v3's block l0 is not the MoE layer")
    T, D, E, K = MOE_TOKENS, cfg.d_model, cfg.n_experts, \
        cfg.experts_per_token
    x = torch.from_numpy(np.random.default_rng(seed + 23).standard_normal(
        (1, T, D), dtype=np.float32)).to(torch.bfloat16)
    C = max(1, math.ceil(T * K / E * cfg.capacity_factor))
    card, card_aux = L.moe_ffn(x.to(DEV), ffn, cfg)
    card, card_aux = card.cpu(), float(card_aux)
    t0 = time.perf_counter()
    host = tree_map(lambda t: t.cpu(), ffn)
    plain, plain_aux = L.moe_ffn(x, host, cfg)
    cpu_s = time.perf_counter() - t0
    _, gidx = L.top_k(torch.softmax(
        x.reshape(T, D).float() @ host["router"].float(), -1), K)
    dropped = int((torch.bincount(gidx.reshape(-1), minlength=E) - C)
                  .clamp_min(0).sum())
    undropped, _ = L.moe_ffn(x, host, replace(cfg, capacity_factor=E / K))
    err = row_rel_err(card, plain)
    fault = row_rel_err(undropped, plain)
    out = dict(tokens=T, capacity=C, dropped_pairs=dropped,
               max_abs_diff=float((card.float() - plain.float()).abs().max()),
               row_rel_err=err, row_tol=MOE_ROW_TOL, aux_card=card_aux,
               aux_cpu=float(plain_aux), no_drop_row_rel_err=fault,
               cpu_s=cpu_s)
    log(f"deepseek-v3 moe_ffn card vs cpu (bf16, {T} tokens, {E} experts "
        f"top-{K}, capacity {C}, {dropped} of {T * K} pairs dropped; CPU "
        f"{cpu_s:.3f} s with the weights' copy): max abs diff "
        f"{out['max_abs_diff']:.3e}, row err {err:.3e} (tolerance "
        f"{MOE_ROW_TOL:.4g}), aux {card_aux:.6e} vs {out['aux_cpu']:.6e}; "
        f"with no drops the plain output is {fault:.3e} of a row off")
    del host
    if not dropped:
        raise AssertionError("moe_ffn card vs cpu: no pair was dropped")
    if not err <= MOE_ROW_TOL or not math.isclose(card_aux, out["aux_cpu"],
                                                  rel_tol=1e-5):
        raise AssertionError("deepseek-v3 moe_ffn: card and CPU disagree")
    if not fault > MOE_ROW_TOL:
        raise AssertionError(f"moe_ffn card vs cpu: dropping nothing stays "
                             f"within the tolerance ({fault})")
    return out


@contextmanager
def value_read_from_keys():
    """A planted fault: MLA's prefill attention reads k_nope (the first Dv
    columns of its keys) in place of its values."""
    from repro_torch.models import layers as L

    real = L.attention

    def wrong(q, k, v, **kw):
        if q.shape[1] > 1 and v.shape[-1] < k.shape[-1]:
            v = k[..., :v.shape[-1]]
        return real(q, k, v, **kw)
    L.attention = wrong
    try:
        yield
    finally:
        L.attention = real


def prefill_and_step(params, cfg, toks, device):
    """A prefill of all but the last token into a cache on ``device`` and
    one decode step: (prefill logits, step logits), moved to the host."""
    from repro_torch.models import model as M

    S = toks.shape[1] - 1
    cache = M.init_cache(cfg, toks.shape[0], S + 1, device=device)
    pre, cache = M.serve_step(params, cfg, {"tokens": toks[:, :S]}, cache, 0)
    step, _ = M.serve_step(params, cfg, {"tokens": toks[:, S:]}, cache, S)
    return pre.cpu(), step.cpu()


def hold_card_to_cpu(what: str, card, plain, faults: dict, greedy=True):
    """logits of the card within 2e-3 of the CPU's (tests/test_arch_smoke.py's
    decode tolerance) and, for a decoder, the same next greedy token; each
    planted fault must move the CPU's logits by more than 2e-3."""
    diff = float((card - plain).abs().max())
    same = bool(torch.equal(card[:, -1].argmax(-1), plain[:, -1].argmax(-1)))
    moved = {f: float((w - plain).abs().max()) for f, w in faults.items()}
    log(f"{what}: max abs logit diff {diff:.3e} (tolerance 2e-3; logits up "
        f"to {float(plain.abs().max()):.4f})"
        + (f", next greedy token equal: {same}" if greedy else "")
        + "".join(f"; {f} moves the plain logits by {d:.3e}"
                  for f, d in moved.items()))
    if not torch.allclose(card, plain, atol=2e-3, rtol=2e-3) or \
            (greedy and not same):
        raise AssertionError(f"{what}: card and CPU disagree")
    if not all(d > 2e-3 for d in moved.values()):
        raise AssertionError(f"{what}: a planted fault stays within the "
                             f"tolerance: {moved}")
    return dict(max_abs_diff=diff, next_token_equal=same,
                planted_fault_max_abs_diff=moved)


def deepseek_card_vs_cpu_phase(seed: int) -> dict:
    """deepseek-v3 at full width cut to one dense layer, fp32 compute: a
    512-token prefill and one absorbed decode step on the card (kernel)
    and on the CPU (plain), logits within 2e-3 and the same next greedy
    token; a dropped causal mask and v read from k_nope (on the CPU) must
    each move the prefill's logits by more than 2e-3."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map

    cfg = replace(get_config("deepseek-v3-671b"), n_layers=1,
                  first_dense_layers=1, compute_dtype="float32")
    params = M.cast_params(M.init_params(
        cfg, torch.Generator(device=DEV).manual_seed(seed + 5), device=DEV),
        cfg)
    toks = torch.from_numpy(np.random.default_rng(seed + 11).integers(
        0, cfg.vocab_size, (1, DS_CUT + 1)))
    zero_flash_counts()
    card = prefill_and_step(params, cfg, toks.to(DEV), DEV)
    expect_flash(flash_counts(), 1, "cuda_cores", "deepseek-v3 fp32 prefill")
    host = tree_map(lambda t: t.cpu(), params)
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    plain = prefill_and_step(host, cfg, toks, "cpu")
    cpu_s = time.perf_counter() - t0
    one = {"tokens": toks[:, :DS_CUT]}
    faults = {"causality dropped": M.serve_step(
        host, replace(cfg, causal=False), one, None, None)[0]}
    with value_read_from_keys():
        faults["v read from k_nope"] = M.serve_step(host, cfg, one, None,
                                                    None)[0]
    if flash_counts()["all"] != 1:
        raise AssertionError("the CPU prefill launched the kernel")
    out = dict(cpu_s=cpu_s)
    out["prefill"] = hold_card_to_cpu(
        f"deepseek-v3 card vs cpu (fp32, 1 dense layer, 1 x {DS_CUT} "
        f"prefill; CPU {cpu_s:.3f} s with the step)", card[0], plain[0],
        faults)
    out["decode"] = hold_card_to_cpu(
        "deepseek-v3 card vs cpu (fp32, absorbed decode step)", card[1],
        plain[1], {})
    del host
    return out


HUBERT_BATCH, HUBERT_FRAMES = 8, 1500     # 30 s of audio at 50 frames/s


def hubert_phase(seed: int, card: str) -> dict:
    """hubert-xlarge at full width and depth (48 layers, bf16, weights from
    --seed): one whole-sequence forward of 8 x 1500 frame embeddings (one
    flash launch a layer, tensor cores, D 80, non-causal); then cut to 2
    layers in fp32, 256 frames on the card and on the CPU, logits within
    2e-3, where a causal mask must move them by more than 2e-3."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map

    cfg = get_config("hubert-xlarge")
    out = describe(cfg, ["weights random from --seed (init_params)"], card)
    out["params_gb"] = cfg.param_count() * 2 / 1e9
    torch.cuda.reset_peak_memory_stats()
    params = M.cast_params(M.init_params(
        cfg, torch.Generator(device=DEV).manual_seed(seed + 13), device=DEV),
        cfg)
    rng = np.random.default_rng(seed + 13)
    frames = torch.from_numpy(rng.normal(
        size=(HUBERT_BATCH, HUBERT_FRAMES, cfg.frontend_dim)).astype(
            np.float32)).to(DEV)
    zero_flash_counts()
    fwd = serve.forward(params, cfg, {"frames": frames})
    out["flash"] = flash_counts()
    expect_flash(out["flash"], cfg.n_layers, "tensor_cores", "hubert forward")
    if tuple(fwd.logits.shape) != (HUBERT_BATCH, HUBERT_FRAMES,
                                   cfg.vocab_size) or \
            not bool(torch.isfinite(fwd.logits).all()):
        raise AssertionError(f"hubert logits {tuple(fwd.logits.shape)} not "
                             f"finite or not [B,S,V]")
    warm, out["forward_profile"] = device_window(
        lambda: serve.forward(params, cfg, {"frames": frames}))
    log_profile("hubert warm forward", out["forward_profile"])
    out.update(forward_ms=fwd.seconds * 1e3, forward_ms_warm=warm.seconds * 1e3,
               frames_per_s=HUBERT_BATCH * HUBERT_FRAMES / warm.seconds,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"hubert forward {HUBERT_BATCH} x {HUBERT_FRAMES} frames: "
        f"{out['forward_ms']:.3f} ms cold, {out['forward_ms_warm']:.3f} ms "
        f"warm ({out['frames_per_s']:.1f} frames/s), {out['flash']['all']} "
        f"flash launches ({out['flash']['tensor_cores']} on the tensor cores, D "
        f"{cfg.resolved_head_dim}); params {out['params_gb']:.3f} GB; peak "
        f"device memory {out['peak_memory_gb']:.3f} GB")
    del params, fwd, warm, frames
    torch.cuda.empty_cache()

    small = replace(cfg, n_layers=2, compute_dtype="float32")
    params = M.cast_params(M.init_params(
        small, torch.Generator(device=DEV).manual_seed(seed + 17),
        device=DEV), small)
    frames = torch.from_numpy(rng.normal(size=(1, 256, cfg.frontend_dim))
                              .astype(np.float32))
    zero_flash_counts()
    got, _ = M.serve_step(params, small, {"frames": frames.to(DEV)}, None,
                          None)
    expect_flash(flash_counts(), 2, "cuda_cores", "hubert fp32 forward")
    host = tree_map(lambda t: t.cpu(), params)
    del params
    plain, _ = M.serve_step(host, small, {"frames": frames}, None, None)
    causal, _ = M.serve_step(host, replace(small, causal=True),
                             {"frames": frames}, None, None)
    out["card_vs_cpu"] = hold_card_to_cpu(
        "hubert card vs cpu (fp32, 2 layers, 1 x 256 frames)", got.cpu(),
        plain, {"a causal mask": causal}, greedy=False)
    torch.cuda.empty_cache()
    return out


LLAVA_LAYERS, LLAVA_BATCH, LLAVA_TOKENS, LLAVA_DECODE = 2, 2, 1216, 8
# changing the patch embeddings must move the token positions' logits by
# more than bf16 noise: 0.05 is the gemma2 teacher-forced tolerance (13 bf16
# spacings at 0.5)
LLAVA_PATCH_MOVE = 5e-2


def llava_phase(seed: int, card: str) -> dict:
    """llava-next-34b at its published widths cut to 2 of its 60 layers,
    bf16, weights from --seed: 2 prompts of 2880 patch embeddings of 1024
    and 1216 tokens (4096 positions) prefilled (one flash launch a layer,
    tensor cores, D 128, 56 heads over 8) and 8 greedy decode steps; the
    logits finite, and other patches must move the token positions'
    logits."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    published = get_config("llava-next-34b")
    cfg = replace(published, n_layers=LLAVA_LAYERS)
    out = describe(cfg, [
        f"n_layers {published.n_layers} -> {cfg.n_layers}",
        "weights random from --seed (init_params)"], card)
    out["params_gb"] = cfg.param_count() * 2 / 1e9
    torch.cuda.reset_peak_memory_stats()
    params = M.cast_params(M.init_params(
        cfg, torch.Generator(device=DEV).manual_seed(seed + 19), device=DEV),
        cfg)
    rng = np.random.default_rng(seed + 19)
    B, Np, P = LLAVA_BATCH, cfg.n_patches, LLAVA_TOKENS

    def patches():
        return torch.from_numpy(rng.normal(size=(B, Np, cfg.frontend_dim))
                                .astype(np.float32)).to(DEV)
    first = patches()
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P))
                               ).to(DEV)
    zero_flash_counts()
    res = serve.generate(params, cfg, prompts, LLAVA_DECODE + 1,
                         patches=first)
    out["flash"] = flash_counts()
    expect_flash(out["flash"], cfg.n_layers, "tensor_cores",
                 "llava prefill + decode")
    logits = res.prefill_logits
    if tuple(logits.shape) != (B, Np + P, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"llava logits {tuple(logits.shape)} not finite "
                             f"or not [B,S,V]")
    other, _ = M.serve_step(params, cfg, {"patches": patches(),
                                          "tokens": prompts}, None, None)
    moved = float((other[:, Np:].float() - logits[:, Np:].float()).abs()
                  .max())
    out.update(prefill_ms=res.prefill_s * 1e3,
               prefill_positions_per_s=B * (Np + P) / res.prefill_s,
               decode_ms_per_step=res.decode_s * 1e3 / res.decode_steps,
               decode_steps=res.decode_steps, patches_move_tokens=moved,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"llava prefill {B} x ({Np} patches + {P} tokens) in "
        f"{out['prefill_ms']:.3f} ms, {out['flash']['all']} flash launches "
        f"({out['flash']['tensor_cores']} on the tensor cores); decode "
        f"{res.decode_steps} steps, {out['decode_ms_per_step']:.3f} ms/step; "
        f"other patches move the token positions' logits by {moved:.4e} "
        f"(must exceed {LLAVA_PATCH_MOVE}); params {out['params_gb']:.3f} "
        f"GB; peak device memory {out['peak_memory_gb']:.3f} GB")
    if not moved > LLAVA_PATCH_MOVE:
        raise AssertionError("llava: the token positions do not see the "
                             "patches")
    del params, logits, res, other
    torch.cuda.empty_cache()
    return out


# ---------------- the configs one card holds, at full depth -------------- #

# (arch, batch, prompt positions): qwen2-7b, command-r-35b,
# moonshot-v1-16b-a3b and llava-next-34b at their published widths and
# depths, bf16, weights from --seed; llava's prompt is its 2880 patches
# followed by tokens.  A batch that runs out of device memory is halved
# (and listed under ``reduced``).
WHOLE_SERVE = [("qwen2-7b", 2, 8192), ("command-r-35b", 1, 8192),
               ("moonshot-v1-16b-a3b", 2, 4096), ("llava-next-34b", 1, 4096)]
WHOLE_DECODE = 32
WHOLE_CUT = 64                 # dense: prefill P - 64 positions, decode 4
WHOLE_MOE_CUT = 512            # MoE: a 516-token sequence, prefill 512
# init's peak above what was allocated before it: at most the param bytes,
# one block's slice of the largest block leaf in fp32 (the largest draw)
# and this slack
WHOLE_INIT_SLACK = 1 << 30
# The teacher-forced decode's distance from the prefill's logits, as a
# share of the largest |logit| at the four positions, held at deepseek-v3's
# DS_TEACHER_REL_TOL for moonshot and for WHOLE_E2E_HELD.  On an H100
# (700 W) it came to 1.8% (qwen2-7b, 28 layers), 5.8% (command-r, 40) and
# 7.5% (llava-next, 60): past it for the two deeper dense configs, whose
# bf16 prefill is itself 20% and 30% from the fp32 forward below.
WHOLE_TEACHER_REL_TOL = DS_TEACHER_REL_TOL
WHOLE_E2E_HELD = ("qwen2-7b",)
# Every dense config's decode is also held against a second witness, a
# forward of the same prompt in fp32 (each layer's bf16 params cast as it
# runs, TF32 off) at the four positions: the decode's distance from it may
# be at most WHOLE_REF_FACTOR times the bf16 prefill's own distance from
# it.  Both bf16 paths round every layer, so at random init each lands
# about as far from the fp32 forward as the other (set before the check's
# first run on the card).
WHOLE_REF_FACTOR = 1.5
# The dense configs' decode, layer by layer: each layer fed the prefill's
# input at the decode position, and three of its values held to the
# prefill's from the same input within two bf16 spacings of each element
# (each path rounds them) plus this share of the largest: the layer's
# output (of its largest increment: a few bf16 roundings inside, the flash
# kernel's unnormalised P against the direct path's normalised p, GEMV
# against GEMM products), its attention's output (of its largest value:
# the direct path against the flash kernel, a decode-only path), and the
# K and V it writes into the cache at the decode position (of their
# largest value: the cache write and the rotary position).  The last two
# are set before their first run on the card; a rotary position off by
# one and a write one slot early, planted in the decode, must each fail.
WHOLE_LAYER_TOL = 2.0 ** -6
WHOLE_DECODE_FAULTS = ("rope_off_by_one", "cache_slot_early")
# moonshot routes each of the 4 decode rows in 48 MoE layers (192 top-6
# choices of 64 experts).  Its reference prefill is forced to the decode's
# experts at those rows and to its own unforced choice elsewhere, so both
# paths take the same discrete route; a decode choice that differs from
# what the forced prefill's router would pick must be one expert swapped
# for its (K+1)-th, by a log-probability margin at most twice the two
# paths' router difference at that row (a rounding tie), and at most
# WHOLE_MAX_FLIPS of the 192.
WHOLE_MAX_FLIPS = 8
# qwen2-7b trained whole: the reference run by launch/train.py's main
# (no checkpoint: --ckpt-every beyond the steps), then the checkpointing
# deployment the launcher builds with --store-dir, driven through Trainer
# (the launcher shuts its log down at exit, and a restart needs it): the
# log local+remote with 1 backup at W = 2, WHOLE_STORE_REPLICAS FileStore
# replicas at W = 2 under WHOLE_STORE_DIR (in the checkout, removed at the
# phase's end; its disk must hold the replicas' state bytes times
# WHOLE_DISK_SLACK), each leaf saved in a chunk a stacked layer (a shard's
# frame has a u32 payload length: the launcher's one chunk a leaf cannot
# hold the 7.60 GB wi), force frequency F = WHOLE_JOURNAL_F, the trainer's
# default asynchronous checkpoint every WHOLE_CKPT_EVERY steps, a crash
# after WHOLE_FIRST_LIFE steps and a second life to WHOLE_TRAIN_STEPS.
WHOLE_TRAIN_STEPS = 5
WHOLE_TRAIN_ARGS = ["--arch", "qwen2-7b", "--optimizer", "adafactor",
                    "--batch", "1", "--seq", "4096",
                    "--steps", str(WHOLE_TRAIN_STEPS), "--ckpt-every", "6"]
WHOLE_CKPT_EVERY = 3
WHOLE_FIRST_LIFE = 4
WHOLE_JOURNAL_F = 4
WHOLE_STORE_REPLICAS = 2
WHOLE_STORE_DIR = ROOT / "_whole_ckpt"
WHOLE_DISK_SLACK = 1.1


def param_bytes(cfg) -> tuple[int, int]:
    """(bytes of ``param_specs(cfg)``, fp32 bytes of the largest block
    slice: init's largest draw)."""
    from repro_torch.models import model as M
    from repro_torch.tree import leaf_paths

    specs = M.param_specs(cfg)
    total = sum(math.prod(s.shape) * s.dtype.itemsize
                for _, s in leaf_paths(specs))
    piece = max(math.prod(s.shape[1:]) for _, s in leaf_paths(specs["blocks"]))
    return total, 4 * piece


def init_whole(cfg, seed: int) -> tuple:
    """``init_params`` on the card -> (params, {init_s, param_bytes,
    block_slice_bytes, init_peak_bytes above the start}); raises if the
    peak passes param bytes + block slice + WHOLE_INIT_SLACK."""
    from repro_torch.models import model as M

    nbytes, piece = param_bytes(cfg)
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.cast_params(M.init_params(
        cfg, torch.Generator(device=DEV).manual_seed(seed), device=DEV), cfg)
    torch.cuda.synchronize()
    info = dict(init_s=time.perf_counter() - t0, param_bytes=nbytes,
                block_slice_bytes=piece,
                init_peak_bytes=torch.cuda.max_memory_allocated() - start)
    limit = nbytes + piece + WHOLE_INIT_SLACK
    if info["init_peak_bytes"] > limit:
        raise AssertionError(f"{cfg.name} init peaked {info['init_peak_bytes']}"
                             f" bytes above its start, more than params "
                             f"{nbytes} + block slice {piece} + "
                             f"{WHOLE_INIT_SLACK}")
    return params, info


def freed_to(start: int, what: str) -> None:
    """Raise unless the card's allocated bytes are back at ``start``."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    now = torch.cuda.memory_allocated()
    if now != start:
        raise AssertionError(f"{what}: {now} bytes allocated after it was "
                             f"freed, {start} before it")


def layer_err(h_in, want, got) -> float:
    """How far one layer's decode output ``got`` is from the prefill's
    ``want``, both from the same input ``h_in`` (bf16), beyond two bf16
    spacings of the larger of |input| and |output| at each element, as a
    share of the layer's largest increment |want - h_in|.  Each path rounds
    the residual sums to bf16, so two spacings is what that rounding alone
    allows."""
    want, got, h_in = want.float(), got.float(), h_in.float()
    _, e = torch.frexp(torch.maximum(want.abs(), h_in.abs()))
    spacing = torch.ldexp(torch.ones_like(want), e - 8)
    beyond = ((got - want).abs() - 2 * spacing).clamp_min(0)
    return float(beyond.max() / (want - h_in).abs().max())


@contextmanager
def layer_io(rows=None, inputs=None):
    """Record each layer's (input, output) residual stream into the
    yielded list, only the positions ``rows`` where given; with
    ``inputs``, the n-th layer takes ``inputs[n]`` instead of its own
    input.  Harness only: ``model._apply_layer`` is restored after."""
    from repro_torch.models import model as M

    real, calls = M._apply_layer, []
    keep = slice(None) if rows is None else rows

    def apply(h, *args):
        if inputs is not None:
            h = inputs[len(calls)]
        out = real(h, *args)
        calls.append((h[:, keep].clone(), out[0][:, keep].clone()))
        return out
    M._apply_layer = apply
    try:
        yield calls
    finally:
        M._apply_layer = real


@contextmanager
def mixer_io(rows=None):
    """Record each attention layer's output (before the residual add) into
    the yielded list, only the positions ``rows`` where given.  Harness
    only: ``layers.gqa_attention`` is restored after."""
    from repro_torch.models import layers as L

    real, outs = L.gqa_attention, []
    keep = slice(None) if rows is None else rows

    def attn(x, *args, **kw):
        y, cache = real(x, *args, **kw)
        outs.append(y[:, keep].clone())
        return y, cache
    L.gqa_attention = attn
    try:
        yield outs
    finally:
        L.gqa_attention = real


@contextmanager
def logits_at(rows):
    """``model._logits`` computes only the positions ``rows``: a reference
    forward then keeps [B, len(rows), V] and not [B, S, V].  Harness
    only."""
    from repro_torch.models import model as M

    real = M._logits
    M._logits = lambda params, cfg, h: real(params, cfg, h[:, rows])
    try:
        yield
    finally:
        M._logits = real


@contextmanager
def planted_decode(fault):
    """A planted decode fault (WHOLE_DECODE_FAULTS), or none: the rotary
    tables of a one-token step taken one position late, or a decode step's
    new K and V moved one slot early in the cache (the previous token's
    overwritten, its own slot left empty) before it attends."""
    from repro_torch.models import layers as L

    if fault is None:
        yield
        return
    if fault == "rope_off_by_one":
        name, real = "rope_tables", L.rope_tables

        def wrong(positions, dim, theta):
            if positions.shape[-1] == 1:
                positions = positions + 1
            return real(positions, dim, theta)
    elif fault == "cache_slot_early":
        name, real = "attention", L.attention

        def wrong(q, k, v, *, q_offset=0, kv_len=None, **kw):
            if kv_len is not None:                   # a decode step
                for t in (k, v):
                    t[:, q_offset - 1] = t[:, q_offset]
                    t[:, q_offset] = 0
            return real(q, k, v, q_offset=q_offset, kv_len=kv_len, **kw)
    else:
        raise ValueError(fault)
    setattr(L, name, wrong)
    try:
        yield
    finally:
        setattr(L, name, real)


def kv_rows(cache, start: int) -> dict:
    """Each block cache leaf's rows start..start+3: {name: [nb, B, 4, ...]}."""
    from repro_torch.tree import leaf_paths

    return {n: t[:, :, start:start + 4].clone()
            for n, t in leaf_paths(cache["blocks"])}


def forced_decode(params, cfg, cache, tokens, t: int, cut: int, ref,
                  ref_mix, ref_kv, fault=None) -> dict:
    """Four decode steps at positions cut..cut+3 from ``cache`` (a prefill
    of ``cut`` positions), each layer fed the prefill's input there (``ref``
    from ``layer_io``), with ``fault`` planted: the largest ``layer_err`` of
    each layer's output, its attention's output (against ``ref_mix``) and
    the K/V it wrote (against ``ref_kv``), by layer."""
    from repro_torch.models import model as M

    n = len(ref)
    out = {"layer": [0.0] * n, "mixer": [0.0] * n}
    with planted_decode(fault):
        for j in range(4):
            with layer_io(inputs=[i[:, j:j + 1] for i, _ in ref]) as dec, \
                    mixer_io() as mix:
                M.serve_step(params, cfg,
                             {"tokens": tokens[:, t + j:t + j + 1]}, cache,
                             cut + j)
            for i, ((ri, ro), (_, do), rm, dm) in enumerate(
                    zip(ref, dec, ref_mix, mix)):
                out["layer"][i] = max(out["layer"][i], layer_err(
                    ri[:, j], ro[:, j], do[:, 0]))
                out["mixer"][i] = max(out["mixer"][i], layer_err(
                    torch.zeros_like(rm[:, j]), rm[:, j], dm[:, 0]))
    got = kv_rows(cache, cut)
    out["cache"] = [max(layer_err(torch.zeros_like(w[b]), w[b], got[name][b])
                        for name, w in ref_kv.items())
                    for b in range(cfg.n_blocks)]
    return out


def fp32_logits_at(params, cfg, first: dict, rows) -> torch.Tensor:
    """The logits at ``rows`` of a forward over ``first`` in fp32: the bf16
    params cast a layer at a time (the forward's own cast to the compute
    dtype), fp32 activations, the mma.sync flash kernel (the "cuda_cores"
    route: three TF32 products a product); the caller keeps TF32 off for
    the plain products."""
    from dataclasses import replace

    from repro_torch.models import model as M

    with logits_at(rows):
        lg, _ = M.serve_step(params, replace(cfg, compute_dtype="float32"),
                             first, None, None)
    return lg.float()


def dense_teacher_forced(params, cfg, prompts, patches, positions: int,
                         want: torch.Tensor) -> dict:
    """The dense configs' teacher-forced decode at positions cut..cut+3
    (cut = positions - WHOLE_CUT) against ``want``, the bf16 prefill's
    logits there: the decode's distance from them; the per-layer checks
    (``forced_decode``) clean and under each of WHOLE_DECODE_FAULTS; and
    both bf16 paths' distance from an fp32 forward (``fp32_logits_at``)."""
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map

    B, Np = prompts.shape[0], 0 if patches is None else patches.shape[1]
    cut = positions - WHOLE_CUT
    rows = slice(cut, cut + 4)
    t = cut - Np                                 # tokens before the cut

    def prefix(n):
        first = {"tokens": prompts[:, :n]}
        if Np:
            first["patches"] = patches
        return first
    # one forward over the whole prompt: each layer's input, output and
    # attention output at the 4 positions, and the K/V it caches there
    cache = M.init_cache(cfg, B, positions, device=prompts.device)
    with layer_io(rows=rows) as ref, mixer_io(rows=rows) as ref_mix, \
            logits_at(rows):
        M.serve_step(params, cfg, prefix(positions - Np), cache, 0)
    ref_kv = kv_rows(cache, cut)
    del cache
    cache0 = M.init_cache(cfg, B, cut + 4, device=prompts.device)
    M.serve_step(params, cfg, prefix(t), cache0, 0)
    cache = tree_map(torch.clone, cache0)
    steps = []
    for j in range(4):
        step, cache = M.serve_step(
            params, cfg, {"tokens": prompts[:, t + j:t + j + 1]}, cache,
            cut + j)
        steps.append(step[:, 0].float())
    dec = torch.stack(steps, dim=1)                  # [B, 4, V]
    checks = {}
    for fault in (None,) + WHOLE_DECODE_FAULTS:
        cache = tree_map(torch.clone, cache0)
        checks[fault or "clean"] = forced_decode(
            params, cfg, cache, prompts, t, cut, ref, ref_mix, ref_kv, fault)
    del cache, cache0
    t32 = time.perf_counter()
    ref32 = fp32_logits_at(params, cfg, prefix(t + 4), rows)
    float(ref32.abs().max())                     # the forward has finished
    fp32_s = time.perf_counter() - t32
    log(f"whole {cfg.name}: the fp32 forward (a flash launch a layer on the "
        f"mma.sync route) {fp32_s:.3f} s")
    scale = float(want.abs().max())
    return dict(
        fp32_forward_s=fp32_s,
        teacher_forced_diffs=[float((dec[:, j] - want[:, j]).abs().max())
                              for j in range(4)],
        teacher_forced_scale=scale, logits_std=float(want.std()),
        prefill_vs_fp32=float((want - ref32).abs().max()) / scale,
        decode_vs_fp32=float((dec - ref32).abs().max()) / scale,
        layer_checks={k: {n: max(v) for n, v in c.items()}
                      for k, c in checks.items()},
        layer_errs=checks["clean"]["layer"],
        mixer_errs=checks["clean"]["mixer"],
        cache_errs=checks["clean"]["cache"])


def moe_teacher_forced(params, cfg, tokens: torch.Tensor) -> dict:
    """A 516-token sequence of a MoE config that drops no token: the
    reference is one whole-sequence forward; the decode path prefills the
    first 512 under the reference's routing and decodes 4 teacher-forced
    steps under its own; the reference again, forced to the decode's
    experts at those 4 rows.  -> the four rows' logit differences, the
    flips (see WHOLE_MAX_FLIPS) and the router inputs' distance."""
    from repro_torch.models import model as M

    cut = WHOLE_MOE_CUT
    rows = torch.arange(cut, cut + 4, device=DEV)
    with moe_routing() as ref_calls:
        M.serve_step(params, cfg, {"tokens": tokens}, None, None)
    pre = {c: (torch.arange(cut, device=DEV), idx[:cut])
           for c, (_, idx) in enumerate(ref_calls)}
    cache = M.init_cache(cfg, 1, cut + 4, device=DEV)
    with moe_routing(pre):
        M.serve_step(params, cfg, {"tokens": tokens[:, :cut]}, cache, 0)
    steps, dec = [], []
    for j in range(4):
        with moe_routing() as calls:
            step, cache = M.serve_step(
                params, cfg, {"tokens": tokens[:, cut + j:cut + j + 1]},
                cache, cut + j)
        steps.append(step[:, 0].float())
        dec.append(calls)
    force = {c: (rows, torch.stack([dec[j][c][1][0] for j in range(4)]))
             for c in range(len(ref_calls))}
    with moe_routing(force) as fwd_calls:
        full, _ = M.serve_step(params, cfg, {"tokens": tokens}, None, None)
    want = full[:, cut:cut + 4].float()
    K = cfg.experts_per_token
    flips, noise = [], 0.0
    for c, (probs, _) in enumerate(fwd_calls):
        for j in range(4):
            lp = probs[cut + j].clamp_min(1e-30).log()
            ld = dec[j][c][0][0].clamp_min(1e-30).log()
            delta = ld - lp
            here = float((delta - delta.median()).abs().max())
            noise = max(noise, here / float(lp.max() - lp.min()))
            order = lp.argsort(descending=True).tolist()
            mine, theirs = set(order[:K]), set(dec[j][c][1][0].tolist())
            if mine != theirs:
                dropped, added = sorted(mine - theirs), sorted(theirs - mine)
                flips.append(dict(
                    call=c, row=cut + j, dropped=dropped, added=added,
                    added_ranks=[order.index(e) for e in added],
                    log_margin=float(lp[dropped].min() - lp[added].max()),
                    router_diff=here))
    diffs = [float((steps[j] - want[:, j]).abs().max()) for j in range(4)]
    return dict(diffs=diffs, scale=float(want.abs().max()), flips=flips,
                router_rel_diff=noise)


def check_moe_flips(what: str, flips: list, K: int) -> None:
    if len(flips) > WHOLE_MAX_FLIPS:
        raise AssertionError(f"{what}: {len(flips)} routings differ between "
                             f"the decode and the forced prefill (at most "
                             f"{WHOLE_MAX_FLIPS}): {flips}")
    for f in flips:
        if len(f["dropped"]) != 1 or f["added_ranks"] != [K] or \
                not f["log_margin"] <= 2 * f["router_diff"]:
            raise AssertionError(f"{what}: a routing the rounding does not "
                                 f"explain: {f}")


def whole_serving(arch: str, batch: int, positions: int, seed: int,
                  card: str) -> dict:
    """``arch`` whole at its published widths, bf16: init (peak bounded),
    ``launch/serve.generate`` of ``batch`` x ``positions`` and WHOLE_DECODE
    steps (a flash launch a layer, tensor cores), finite logits, then the
    teacher-forced decode against a prefill; the card's allocated bytes
    back at their start once the path's tensors are gone."""
    start = torch.cuda.memory_allocated()
    out = serve_whole(arch, batch, positions, seed, card)
    freed_to(start, f"{arch} serving")
    return out


def serve_whole(arch: str, batch: int, positions: int, seed: int,
                card: str) -> dict:
    """``whole_serving``'s path; returns numbers only, so that every
    tensor it made is gone when it returns."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    cfg = get_config(arch)
    reduced = ["weights random from --seed (init_params), no checkpoint"]
    moe = bool(cfg.n_experts)
    if moe:
        dropless = cfg.n_experts / cfg.experts_per_token
        reduced.append(f"teacher-forced check only: capacity_factor "
                       f"{cfg.capacity_factor} -> {dropless:g} on a "
                       f"{WHOLE_MOE_CUT + 4}-token sequence (C = T: no "
                       f"token dropped), see WHOLE_MAX_FLIPS")
    params, out = init_whole(cfg, seed + 41)
    rng = np.random.default_rng(seed + 41)
    Np = cfg.n_patches if cfg.input_kind == "tokens+patches" else 0
    B = batch
    while True:
        torch.cuda.reset_peak_memory_stats()
        patches = None if not Np else torch.from_numpy(rng.normal(
            size=(B, Np, cfg.frontend_dim)).astype(np.float32)).to(DEV)
        prompts = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, positions - Np))).to(DEV)
        zero_flash_counts()
        try:
            res = serve.generate(params, cfg, prompts, WHOLE_DECODE + 1,
                                 patches=patches)
            break
        except torch.cuda.OutOfMemoryError:
            if B == 1:
                raise
            reduced.append(f"batch {B} -> {B // 2}: out of device memory")
            B //= 2
            del patches, prompts
            torch.cuda.empty_cache()
    out.update(describe(cfg, reduced, card))
    out["flash"] = flash_counts()
    expect_flash(out["flash"], cfg.n_layers, "tensor_cores",
                 f"{arch} prefill + decode")
    logits = res.prefill_logits
    if tuple(logits.shape) != (B, positions, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch} prefill logits {tuple(logits.shape)} "
                             f"not finite or not [B,S,V]")
    toks = res.tokens
    if tuple(toks.shape) != (B, WHOLE_DECODE + 1) or int(toks.min()) < 0 or \
            int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"{arch}: decoded tokens out of range")
    out.update(batch=B, positions=positions, patches=Np,
               prefill_ms=res.prefill_s * 1e3,
               prefill_tokens_per_s=B * positions / res.prefill_s,
               decode_ms_per_step=res.decode_s * 1e3 / res.decode_steps,
               decode_tokens_per_s=B * res.decode_steps / res.decode_s,
               decode_steps=res.decode_steps,
               serve_peak_bytes=torch.cuda.max_memory_allocated())
    zero_flash_counts()
    if moe:
        tf = replace(cfg, capacity_factor=dropless)
        one = prompts[:1, :WHOLE_MOE_CUT + 4]
        del logits, res
        torch.cuda.empty_cache()
        r = moe_teacher_forced(params, tf, one)
        expect_flash(flash_counts(), 3 * cfg.n_layers, "tensor_cores",
                     f"{arch} teacher-forced prefills")
        out.update(teacher_forced_diffs=r["diffs"],
                   teacher_forced_scale=r["scale"],
                   teacher_forced_flips=r["flips"],
                   teacher_forced_router_rel_diff=r["router_rel_diff"])
    else:
        cut = positions - WHOLE_CUT
        want = logits[:, cut:cut + 4].float().clone()
        del logits, res
        torch.cuda.empty_cache()
        out.update(dense_teacher_forced(params, cfg, prompts, patches,
                                        positions, want))
        # bf16: the whole prompt and the cut prefill on the tensor cores;
        # the fp32 forward on the CUDA cores
        n, counts = cfg.n_layers, flash_counts()
        if (counts["all"], counts["tensor_cores"], counts["cuda_cores"]) != \
                (3 * n, 2 * n, n):
            raise AssertionError(f"{arch} teacher-forced prefills: flash "
                                 f"launches {counts}, expected {2 * n} on "
                                 f"the tensor cores and {n} (fp32) on the "
                                 f"CUDA cores")
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    worst = max(out["teacher_forced_diffs"])
    flips = out.get("teacher_forced_flips")
    log(f"whole {arch} ({card}): {cfg.n_layers} layers, params "
        f"{out['param_bytes'] / 1e9:.3f} GB, init {out['init_s']:.3f} s "
        f"peaking {out['init_peak_bytes'] / 1e9:.3f} GB (limit params + block "
        f"slice {out['block_slice_bytes'] / 1e9:.3f} GB + 1 GiB); prefill "
        f"{B} x {positions}{f' ({Np} patches)' if Np else ''} in "
        f"{out['prefill_ms']:.3f} ms ({out['prefill_tokens_per_s']:.1f} "
        f"positions/s), decode {out['decode_steps']} steps at "
        f"{out['decode_ms_per_step']:.3f} ms/step; flash launches "
        f"{out['flash']} (all tensor cores); peak device memory "
        f"{out['peak_bytes'] / 1e9:.3f} GB; teacher-forced max abs diff "
        f"{worst:.4e} of largest logit {out['teacher_forced_scale']:.4f} "
        f"(tolerance {WHOLE_TEACHER_REL_TOL} of it)"
        + ("" if "layer_errs" not in out else
           f" for {WHOLE_E2E_HELD}, logits' std {out['logits_std']:.4f}; "
           f"from an fp32 forward: the bf16 prefill "
           f"{out['prefill_vs_fp32']:.4e}, the decode "
           f"{out['decode_vs_fp32']:.4e} of the largest logit (at most "
           f"{WHOLE_REF_FACTOR} times the prefill's); decode vs prefill "
           f"from the same input, beyond two bf16 spacings, at most (layer "
           f"output of its increment, attention output, cached K/V of "
           f"their largest; tolerance {WHOLE_LAYER_TOL}): "
           f"{out['layer_checks']}; by layer "
           f"{[round(e, 5) for e in out['layer_errs']]}, "
           f"{[round(e, 5) for e in out['mixer_errs']]}, "
           f"{[round(e, 5) for e in out['cache_errs']]}")
        + ("" if flips is None else
           f"; {len(flips)} routings differ (at most {WHOLE_MAX_FLIPS}): "
           f"{flips}; router inputs {out['teacher_forced_router_rel_diff']:.4e}"
           f" apart"))
    if flips is not None:
        check_moe_flips(arch, flips, cfg.experts_per_token)
        if not out["teacher_forced_router_rel_diff"] <= WHOLE_TEACHER_REL_TOL:
            raise AssertionError(f"{arch}: router inputs of the decode and "
                                 f"the prefill too far apart")
    if "layer_errs" in out:
        checks = out["layer_checks"]
        if not max(checks["clean"].values()) <= WHOLE_LAYER_TOL:
            raise AssertionError(f"{arch}: a decode layer computes other "
                                 f"values than the prefill's from the same "
                                 f"input: {checks['clean']}")
        for fault in WHOLE_DECODE_FAULTS:
            if not max(checks[fault].values()) > WHOLE_LAYER_TOL:
                raise AssertionError(f"{arch}: a decode with {fault} passes "
                                     f"the per-layer check: {checks[fault]}")
        if not out["decode_vs_fp32"] <= \
                WHOLE_REF_FACTOR * out["prefill_vs_fp32"]:
            raise AssertionError(f"{arch}: the decode is further from the "
                                 f"fp32 forward ({out['decode_vs_fp32']}) "
                                 f"than {WHOLE_REF_FACTOR} times the bf16 "
                                 f"prefill ({out['prefill_vs_fp32']})")
    if ("layer_errs" not in out or arch in WHOLE_E2E_HELD) and \
            not worst <= WHOLE_TEACHER_REL_TOL * out["teacher_forced_scale"]:
        raise AssertionError(f"{arch} teacher-forced decode diverges: "
                             f"{out['teacher_forced_diffs']}")
    return out


def whole_train(seed: int, card: str) -> dict:
    """``train_whole`` (the reference run), then ``checkpoint_restart``
    held to it; the card's allocated bytes back at their start after
    each."""
    start = torch.cuda.memory_allocated()
    out, ref_run = train_whole(seed, card)
    freed_to(start, "qwen2-7b whole train")
    t0 = time.perf_counter()
    out["checkpoint_restart"] = checkpoint_restart(seed, card, ref_run, start)
    del ref_run
    freed_to(start, "qwen2-7b checkpointing trainer")
    out["checkpoint_restart"]["phase_s"] = time.perf_counter() - t0
    log(f"phase whole qwen2-7b checkpointing trainer: "
        f"{out['checkpoint_restart']['phase_s']:.3f} s")
    return out


def leaf_hashes(tree) -> dict:
    """{leaf path: plain hash} of every leaf of ``tree``, on its device."""
    from repro_torch.tree import leaf_paths

    return {p: plain_hash(t) for p, t in leaf_paths(tree)}


def uncounted_ms(fn, reps: int = 5) -> float:
    """``timed_ms(fn)`` with the hash kernel's counts left as they were (a
    timing's launches are not the main path's)."""
    from repro_torch.kernels.checksum import checksum

    counts = (checksum.LAUNCHES, checksum.SHORT_ROW_LAUNCHES,
              checksum.LONG_ROW_LAUNCHES)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    try:
        return timed_ms(fn, reps, flush)
    finally:
        (checksum.LAUNCHES, checksum.SHORT_ROW_LAUNCHES,
         checksum.LONG_ROW_LAUNCHES) = counts


def checked_trainer():
    """A subclass of the port's ``Trainer`` for the whole train paths, each
    instance listed in its ``made``: the step as ``train_step`` runs it
    (``grads_and_metrics``, then ``apply_step`` with the journal), timed
    from its start to its loss on the host, its integrity held to the plain
    hash of its grads on the card and, once, the hash's reading of each
    grad in place checked; a checkpoint's leaves hashed (plain) as they are
    saved, and the step loop's time inside ``_checkpoint`` (for an
    asynchronous save, the snapshot to the host) timed; the journal and the
    durable LSN read after ``run``."""
    from repro_torch.kernels.checksum import ref
    from repro_torch.train import step as S
    from repro_torch.train.trainer import Trainer
    from repro_torch.tree import leaf_paths

    class Checked(Trainer):
        made: list = []

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.ms, self.spans, self.no_copy = [], [], None
            self.saved, self.stall_s = {}, {}
            self.step_fn = self.step
            Checked.made.append(self)

        def step(self, state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            grads, met = S.grads_and_metrics(state["params"], batch, self.cfg)
            new, met = S.apply_step(state, grads, met, self.opt_cfg,
                                    journal=True)
            float(met["loss"])                  # the step's end
            t1 = time.perf_counter()
            self.ms.append((t1 - t0) * 1e3)
            self.spans.append((t0, t1))
            if self.no_copy is None:     # the hash reads each grad in place
                self.no_copy = all(
                    ref.as_words(g).data_ptr() == g.data_ptr()
                    for _, g in leaf_paths(grads)
                    if g.numel() * g.element_size() % 4 == 0)
            check_integrity(f"{self.cfg.name} whole step "
                            f"{int(state['step'])}", met, grads)
            return new, met

        def _checkpoint(self, step):
            self.saved[step] = leaf_hashes(self.state)
            t0 = time.perf_counter()
            super()._checkpoint(step)
            self.stall_s[step] = time.perf_counter() - t0

        def run(self, n_steps=None):
            rep = super().run(n_steps)
            self.journal = self.mgr.journal_records()
            self.durable = self.mgr.log.durable_lsn
            return rep

    return Checked


def expect_train_launches(what: str, counts: dict, steps: int, cfg,
                          n_leaves: int) -> None:
    """A whole train run's launches: the flash forward (with block remat)
    and backward on the tensor cores and one hash a grad leaf, each step."""
    inside, _ = attention_layers(cfg)
    want = (steps * 2 * inside, steps * inside, steps * n_leaves)
    got = (counts["tensor_cores"], counts["backward_tensor_cores"],
           counts["hash"]["launches"])
    if got != want or counts["cuda_cores"] or counts["backward_cuda_cores"]:
        raise AssertionError(f"{what} launches {counts}: expected {want} "
                             f"(flash forward with remat, backward, hash) "
                             f"on the tensor cores")


def check_journal(what: str, journal: list, durable: int, steps,
                  losses: list) -> None:
    """``journal`` ((lsn, record) pairs) holds one record a step of
    ``steps`` with its loss, and all of them are durable."""
    records = [r for _, r in journal]
    want = [{"step": s, "loss": loss} for s, loss in zip(steps, losses)]
    if records != want or not durable >= max(lsn for lsn, _ in journal):
        raise AssertionError(f"{what} journal {journal} is not {want} made "
                             f"durable (durable lsn {durable})")


def train_whole(seed: int, card: str) -> tuple:
    """qwen2-7b whole through ``launch/train.py``'s ``main`` with
    WHOLE_TRAIN_ARGS (Adafactor, 1 x 4096, the journal through the
    replicated log, no checkpoint), its trainer ``checked_trainer``'s:
    finite losses, every journal record durable, the flash forward, backward
    and hash launches counted, the peak under the card's memory; then the
    step's integrity hash timed on leaves shaped as its grads (the params)
    and every leaf of the final state hashed.  -> (its numbers, the run:
    the trainer's configs, losses and final hashes)."""
    import io
    from contextlib import redirect_stdout

    from repro_torch.kernels.checksum import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.tree import leaf_paths

    Checked = checked_trainer()
    torch.cuda.reset_peak_memory_stats()
    zero_bwd_counts()
    zero_hash_counts()
    argv = WHOLE_TRAIN_ARGS + ["--seed", str(seed)]
    text = io.StringIO()
    real = launch_train.Trainer
    launch_train.Trainer = Checked
    t0 = time.perf_counter()
    try:
        with redirect_stdout(text):
            launch_train.main(argv)
    finally:
        launch_train.Trainer = real
    run_s = time.perf_counter() - t0
    counts = dict(bwd_counts(), hash=hash_counts())
    peak = torch.cuda.max_memory_allocated()
    (tr,) = Checked.made
    Checked.made.clear()
    cfg = tr.cfg
    seq = int(argv[argv.index("--seq") + 1])
    losses = tr.report.losses
    n_leaves = len(list(leaf_paths(tr.state["params"])))
    hash_ms = uncounted_ms(lambda: ops.tree_checksums(tr.state["params"]))
    run = dict(cfg=cfg, opt=tr.opt_cfg, data=tr.data.cfg, losses=losses,
               final=leaf_hashes(tr.state), n_leaves=n_leaves)
    tr.state = None
    total = torch.cuda.get_device_properties(0).total_memory
    out = describe(cfg, ["weights random from --seed (init_params)",
                         "synthetic Markov tokens (SyntheticDataset)",
                         f"{WHOLE_TRAIN_STEPS} steps, no checkpoint "
                         f"(--ckpt-every beyond them)"], card)
    out.update(argv=argv, losses=losses, step_ms=tr.ms,
               step_ms_median=float(np.median(tr.ms[1:])),
               tokens_per_s=seq / float(np.median(tr.ms[1:])) * 1e3,
               run_s=run_s, peak_bytes=peak, card_bytes=total,
               journal=[r for _, r in tr.journal], durable_lsn=tr.durable,
               hash_reads_grads_in_place=tr.no_copy, launches=counts,
               step_hash_ms=hash_ms,
               launcher_output=text.getvalue().splitlines())
    log(f"whole qwen2-7b train ({card}): {' '.join(argv)}: losses "
        f"{losses}; step ms {tr.ms} (median of the warm ones "
        f"{out['step_ms_median']:.3f}, {out['tokens_per_s']:.1f} tokens/s); "
        f"peak device memory {peak / 1e9:.3f} GB of {total / 1e9:.3f}; "
        f"journal {out['journal']} durable to lsn {tr.durable}; integrity "
        f"equal to the plain hash of the grads at every step, the hash "
        f"reading each grad in place {tr.no_copy}; the step's integrity hash "
        f"({n_leaves} leaves) {hash_ms:.6f} ms; launches {counts}; launcher: "
        f"{out['launcher_output']}")
    if len(losses) != WHOLE_TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"qwen2-7b whole train losses {losses}")
    check_journal("qwen2-7b", tr.journal, tr.durable, range(len(losses)),
                  losses)
    if not tr.no_copy:
        raise AssertionError("the integrity hash copies a grad leaf")
    expect_train_launches("qwen2-7b whole train", counts, WHOLE_TRAIN_STEPS,
                          cfg, n_leaves)
    if not peak < total:
        raise AssertionError(f"qwen2-7b whole train peaked at {peak} bytes")
    return out, run


def host_memory() -> dict:
    """MemTotal and MemAvailable of /proc/meminfo, in bytes."""
    info = {}
    for line in Path("/proc/meminfo").read_text().splitlines():
        key, value = line.split(":", 1)
        if key in ("MemTotal", "MemAvailable"):
            info[key] = int(value.split()[0]) * 1024
    return info


def peak_rss() -> int:
    """The process's peak resident set so far, in bytes."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def flip_byte(path: Path) -> int:
    """A planted media fault: one byte in the middle of the file (inside a
    shard's payload) inverted, made durable; -> its offset."""
    off = path.stat().st_size // 2
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))
        f.flush()
        os.fsync(f.fileno())
    return off


def same_bytes(a: Path, b: Path, chunk: int = 64 << 20) -> bool:
    """Whether two files hold the same bytes (read in chunks)."""
    if a.stat().st_size != b.stat().st_size:
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x = fa.read(chunk)
            if x != fb.read(chunk):
                return False
            if not x:
                return True


@contextmanager
def timed_calls(module, names, into: dict):
    """``module``'s functions ``names`` timed while the block runs (card
    work synchronised at each return): seconds summed into ``into``."""
    real = {n: getattr(module, n) for n in names}

    def timed(name):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = real[name](*a, **kw)
            torch.cuda.synchronize()
            into[name] = into.get(name, 0.0) + time.perf_counter() - t0
            return out
        return call
    for n in names:
        setattr(module, n, timed(n))
    try:
        yield into
    finally:
        for n, fn in real.items():
            setattr(module, n, fn)


def checkpoint_restart(seed: int, card: str, ref_run: dict,
                       start: int) -> dict:
    """The checkpointing trainer on qwen2-7b whole (the deployment of
    WHOLE_TRAIN_ARGS' neighbours above): a first life of WHOLE_FIRST_LIFE
    steps whose step-3 checkpoint ``save_async`` writes while step 3 runs;
    a crash (every object of that life dropped; what survives is the log's
    devices as their media holds them, ``crash(keep_probability=0.0)``,
    and the stores' directories), one byte of the largest shard on replica
    0 flipped; a second life on the log rebuilt from both images by quorum
    recovery and on new FileStore objects over the same directories, which
    restores step 3 (replica 0 fails its CRC, replica 1 serves, read-repair
    rewrites replica 0), re-seats the data from the journal and runs to
    WHOLE_TRAIN_STEPS.  Gates: each restored leaf's plain hash equal to its
    hash as saved; replica 0's file byte-equal to replica 1's after the
    restore; the resumed losses within rtol 1e-5 of the reference run's
    (bitwise reported) and every final leaf's hash equal to its; each
    life's journal its steps, durable; the manifest committed after its
    shards and after step 2's record; integrity, launches, saves + skips
    = 1, peaks under the card's memory.  Timings, host memory and disk are
    reported."""
    import gc
    import shutil
    import threading

    from repro_torch.checkpoint import (CheckpointConfig, CheckpointManager,
                                        FileStore, ReplicatedStore)
    from repro_torch.checkpoint import manager as ckpt_mod
    from repro_torch.core import (CopyAccessor, Log, ReplicaServer,
                                  ReplicaSet, ReplicationGroup, Transport,
                                  quorum_recover)
    from repro_torch.core.replication import build_replica_set
    from repro_torch.data import SyntheticDataset
    from repro_torch.train.step import train_state_specs
    from repro_torch.train.trainer import TrainerConfig
    from repro_torch.tree import leaf_paths

    cfg, opt = ref_run["cfg"], ref_run["opt"]
    state_bytes = sum(math.prod(s.shape) * s.dtype.itemsize
                      for _, s in leaf_paths(train_state_specs(cfg, opt)))
    total = torch.cuda.get_device_properties(0).total_memory
    Checked = checked_trainer()

    class Replica(FileStore):
        """A FileStore replica that times and counts its puts and gets."""

        def __init__(self, root, name):
            super().__init__(root, name)
            self.lock = threading.Lock()
            self.put_s = self.get_s = 0.0
            self.put_bytes = self.get_bytes = 0
            self.put_end: dict = {}

        def put(self, key, data):
            t0 = time.perf_counter()
            super().put(key, data)
            t1 = time.perf_counter()
            with self.lock:
                self.put_s += t1 - t0
                self.put_bytes += len(data)
                self.put_end[key] = t1

        def get(self, key):
            t0 = time.perf_counter()
            data = super().get(key)
            with self.lock:
                self.get_s += time.perf_counter() - t0
                self.get_bytes += len(data)
            return data

    class Quorum(ReplicatedStore):
        """The replicated store, its gets timed (reads, CRCs, repairs)."""
        get_s = 0.0

        def get(self, key, expect_checksum=None):
            t0 = time.perf_counter()
            data = super().get(key, expect_checksum)
            self.get_s += time.perf_counter() - t0
            return data

    def trainer(log_obj):
        replicas = [Replica(str(root / f"replica{i}"), f"fs{i}")
                    for i in range(WHOLE_STORE_REPLICAS)]
        mgr = CheckpointManager(
            Quorum(replicas, write_quorum=WHOLE_STORE_REPLICAS // 2 + 1),
            log_obj, CheckpointConfig(force_freq=WHOLE_JOURNAL_F,
                                      chunks_per_leaf=cfg.n_layers))
        tr = Checked(cfg, opt, SyntheticDataset(cfg, ref_run["data"]), mgr,
                     TrainerConfig(total_steps=WHOLE_TRAIN_STEPS,
                                   ckpt_every=WHOLE_CKPT_EVERY,
                                   journal_freq=WHOLE_JOURNAL_F, seed=seed),
                     device=DEV)
        Checked.made.clear()
        return tr

    root = WHOLE_STORE_DIR
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    out = describe(cfg, ["weights random from --seed (init_params)",
                         "synthetic Markov tokens (SyntheticDataset)",
                         f"{WHOLE_TRAIN_STEPS} steps",
                         f"chunks_per_leaf 1 -> {cfg.n_layers} (a chunk a "
                         f"stacked layer): a shard's frame holds at most "
                         f"2^32 - 1 payload bytes (u32 length), and the "
                         f"stacked wi is 7.60 GB"], card)
    try:
        mem, free = host_memory(), shutil.disk_usage(root).free
        need = WHOLE_STORE_REPLICAS * state_bytes * WHOLE_DISK_SLACK
        out.update(state_bytes=state_bytes, host_memory=mem,
                   store_disk_free=free, store_disk_needed=need)
        log(f"qwen2-7b checkpointing trainer ({card}): state {state_bytes} "
            f"bytes; host MemTotal {mem['MemTotal']} MemAvailable "
            f"{mem['MemAvailable']} bytes; the stores' disk has {free} bytes "
            f"free, {need:.0f} needed ({WHOLE_STORE_REPLICAS} replicas + "
            f"{WHOLE_DISK_SLACK - 1:.0%})")
        if free < need:
            raise AssertionError(f"the stores' disk has {free} bytes free, "
                                 f"{need:.0f} needed")

        # ---- the first life: steps 0-3, the step-3 checkpoint async ---- #
        rs = build_replica_set(mode="local+remote", capacity=1 << 20,
                               n_backups=1, write_quorum=2, device=DEV)
        try:
            first = trainer(rs.log)
            saves = []
            save = first.mgr.save

            def timed_save(step, state, extra=None, sync=False):
                t0 = time.perf_counter()
                lsn = save(step, state, extra, sync)
                saves.append(dict(step=step, lsn=lsn, start=t0,
                                  end=time.perf_counter()))
                return lsn
            first.mgr.save = timed_save
            zero_bwd_counts()
            zero_hash_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            first.init_or_restore()
            rep1 = first.run(n_steps=WHOLE_FIRST_LIFE)
            life1_s = time.perf_counter() - t0
            counts1 = dict(bwd_counts(), hash=hash_counts())
            peak1 = torch.cuda.max_memory_allocated()
            rss1 = peak_rss()
            manifests1 = [(lsn, m["step"])
                          for lsn, m in first.mgr.manifests()]
            # the crash: the log's devices as their media holds them
            images = [d.crash(np.random.default_rng(seed + i),
                              keep_probability=0.0)
                      for i, d in enumerate((rs.primary_dev,
                                             rs.servers[0].device))]
            lcfg = rs.cfg
            first.mgr.close()
        finally:
            rs.shutdown()
        replicas1 = first.mgr.store.replicas
        life1 = dict(losses=rep1.losses, step_ms=first.ms, spans=first.spans,
                     saved=first.saved, stall_s=first.stall_s[WHOLE_CKPT_EVERY],
                     journal=first.journal, durable=first.durable,
                     saved_n=rep1.ckpts_saved, skipped_n=rep1.ckpts_skipped,
                     no_copy=first.no_copy,
                     put_s=[r.put_s for r in replicas1],
                     written=sum(r.put_bytes for r in replicas1),
                     put_end=max(t for r in replicas1
                                 for t in r.put_end.values()))
        del first, rep1, rs, replicas1, save, timed_save
        gc.collect()
        freed_to(start, "qwen2-7b checkpointing trainer's first life")

        # ---- a planted media fault: the largest shard on replica 0 ---- #
        big = max((root / "replica0").iterdir(), key=lambda p: p.stat().st_size)
        flipped_at = flip_byte(big)

        # ---- the second life ---- #
        t0 = time.perf_counter()
        accs = [CopyAccessor.for_device("node0", images[0]),
                CopyAccessor.for_device("node1", images[1])]
        img, recovery = quorum_recover(accs, lcfg, lcfg.write_quorum,
                                       local_name="node0", device=DEV)
        server = ReplicaServer(images[1], server_id="node1")
        group = ReplicationGroup([Transport(server, primary_id="node0")],
                                 lcfg.write_quorum, local_is_durable=True)
        rs2 = ReplicaSet(mode="local+remote", cfg=lcfg, primary_id="node0",
                         primary_dev=img, servers=[server],
                         transports=list(group.transports), group=group,
                         log=Log.open(img, lcfg, repl=group, device=DEV))
        recover_s = time.perf_counter() - t0
        try:
            second = trainer(rs2.log)
            replicas2 = second.mgr.store.replicas
            restore_s = {}
            restore = second.mgr.restore

            def timed_restore(*a, **kw):
                t1 = time.perf_counter()
                got = restore(*a, **kw)
                restore_s["restore"] = time.perf_counter() - t1
                return got
            second.mgr.restore = timed_restore
            zero_bwd_counts()
            zero_hash_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with timed_calls(ckpt_mod, ("decode_shard", "_like"), restore_s):
                restored = second.init_or_restore()
            init_restore_s = time.perf_counter() - t0
            peak_restore = torch.cuda.max_memory_allocated()
            seated = second.data.step
            restored_hashes = leaf_hashes(second.state)
            repaired = same_bytes(big, root / "replica1" / big.name)
            rep2 = second.run()
            counts2 = dict(bwd_counts(), hash=hash_counts())
            peak2 = torch.cuda.max_memory_allocated()
            final = leaf_hashes(second.state)
            manifests2 = [(lsn, m["step"])
                          for lsn, m in second.mgr.manifests()]
            second.mgr.close()
        finally:
            rs2.shutdown()
        life2 = dict(losses=rep2.losses, step_ms=second.ms,
                     journal=second.journal, durable=second.durable,
                     no_copy=second.no_copy,
                     reads=sum(r.get_s for r in replicas2),
                     read_bytes=sum(r.get_bytes for r in replicas2),
                     repair_s=sum(r.put_s for r in replicas2),
                     repair_bytes=sum(r.put_bytes for r in replicas2),
                     quorum_get_s=second.mgr.store.get_s)
        del second, rep2, replicas2, restore, timed_restore
        gc.collect()
        rss2 = peak_rss()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # ---- what was measured ---- #
    (save_rec,) = saves
    save_s = save_rec["end"] - save_rec["start"]
    step3 = life1["spans"][WHOLE_CKPT_EVERY]
    overlapped = save_rec["start"] < step3[1] and save_rec["end"] > step3[0]
    crc_s = life2["quorum_get_s"] - life2["reads"] - life2["repair_s"]
    ref_losses = ref_run["losses"]
    resumed = life2["losses"]
    tail = ref_losses[WHOLE_CKPT_EVERY:]
    first_lsn2 = max(lsn for lsn, _ in life1["journal"])
    journal2 = [(lsn, r) for lsn, r in life2["journal"] if lsn > first_lsn2]
    step2_lsn = dict((r["step"], lsn) for lsn, r in life1["journal"])[
        WHOLE_CKPT_EVERY - 1]
    out.update(
        first_life=dict(losses=life1["losses"], step_ms=life1["step_ms"],
                        run_s=life1_s, peak_bytes=peak1,
                        ckpts_saved=life1["saved_n"],
                        ckpts_skipped=life1["skipped_n"],
                        launches=counts1, peak_rss_bytes=rss1),
        save=dict(step=save_rec["step"], manifest_lsn=save_rec["lsn"],
                  stall_s=life1["stall_s"], save_s=save_s,
                  gb_per_s=state_bytes / save_s / 1e9,
                  overlapped_step=overlapped,
                  step_ms_with_save=life1["step_ms"][WHOLE_CKPT_EVERY],
                  step_ms_without=life1["step_ms"][1:WHOLE_CKPT_EVERY],
                  replica_put_s=life1["put_s"],
                  bytes_written=life1["written"]),
        crash=dict(flipped=f"replica0/{big.name}", offset=flipped_at,
                   recover_s=recover_s, recovery_chosen=recovery.chosen,
                   recovery_epoch=[recovery.old_epoch, recovery.new_epoch]),
        restore=dict(step=restored, data_reseated_at=seated,
                     init_and_restore_s=init_restore_s,
                     restore_s=restore_s["restore"],
                     gb_per_s=state_bytes / restore_s["restore"] / 1e9,
                     store_reads_s=life2["reads"],
                     read_bytes=life2["read_bytes"], crc_s=crc_s,
                     decode_s=restore_s["decode_shard"],
                     to_card_s=restore_s["_like"],
                     repair_s=life2["repair_s"],
                     repair_bytes=life2["repair_bytes"],
                     replica0_repaired=repaired, peak_bytes=peak_restore),
        second_life=dict(losses=resumed, step_ms=life2["step_ms"],
                         peak_bytes=peak2, launches=counts2,
                         peak_rss_bytes=rss2),
        resumed_losses_bitwise_equal=resumed == tail,
        final_hashes_equal=final == ref_run["final"],
        bytes_written=life1["written"] + life2["repair_bytes"])
    sv, rt = out["save"], out["restore"]
    log(f"qwen2-7b checkpointing trainer, first life ({card}): losses "
        f"{life1['losses']}; step ms {life1['step_ms']}; the step-"
        f"{WHOLE_CKPT_EVERY} checkpoint by save_async: the step loop stalled "
        f"{sv['stall_s']:.3f} s (the snapshot to the host), the save took "
        f"{save_s:.3f} s ({sv['gb_per_s']:.3f} GB/s of {state_bytes} bytes: "
        f"encode and CRC, {WHOLE_STORE_REPLICAS} replicas' fsync, the "
        f"manifest's force; the replicas' puts {life1['put_s']} s), overlapping "
        f"step {WHOLE_CKPT_EVERY} {overlapped}; step {WHOLE_CKPT_EVERY} "
        f"{sv['step_ms_with_save']:.3f} ms with the save running against "
        f"{sv['step_ms_without']} without; {life1['written']} bytes written; "
        f"saves {life1['saved_n']} + skipped {life1['skipped_n']}; peak "
        f"device memory {peak1 / 1e9:.3f} GB, host peak RSS {rss1 / 1e9:.3f} "
        f"GB; launches {counts1}; {life1_s:.3f} s")
    log(f"qwen2-7b checkpointing trainer, crash and second life ({card}): "
        f"byte {flipped_at} of replica0/{big.name} flipped; the log rebuilt "
        f"from both images in {recover_s:.3f} s (chose {recovery.chosen}, "
        f"epoch {recovery.old_epoch}->{recovery.new_epoch}); restored step "
        f"{restored} in {rt['restore_s']:.3f} s ({rt['gb_per_s']:.3f} GB/s; "
        f"store reads {rt['store_reads_s']:.3f} s of {rt['read_bytes']} bytes, "
        f"CRCs {crc_s:.3f} s, decode {rt['decode_s']:.3f} s, host to card "
        f"{rt['to_card_s']:.3f} s, read-repair {rt['repair_s']:.3f} s of "
        f"{rt['repair_bytes']} bytes; with the template's init "
        f"{init_restore_s:.3f} s), data re-seated at {seated}; replica 0 "
        f"repaired {repaired}; resumed losses {resumed} against {tail} "
        f"(bitwise {resumed == tail}); final leaves' hashes equal "
        f"{final == ref_run['final']}; step ms {life2['step_ms']}; peak "
        f"device memory {peak_restore / 1e9:.3f} GB at the restore, "
        f"{peak2 / 1e9:.3f} GB; host peak RSS {rss2 / 1e9:.3f} GB; launches "
        f"{counts2}")

    # ---- the gates ---- #
    if restored != WHOLE_CKPT_EVERY or seated != WHOLE_FIRST_LIFE:
        raise AssertionError(f"restored step {restored}, data re-seated at "
                             f"{seated}")
    saved = life1["saved"][WHOLE_CKPT_EVERY]
    if restored_hashes != saved:
        bad = [p for p in saved if restored_hashes.get(p) != saved[p]]
        raise AssertionError(f"restored leaves {bad} differ from the saved")
    if not repaired:
        raise AssertionError(f"replica0/{big.name} was not read-repaired")
    if not np.allclose(resumed, tail, rtol=1e-5, atol=0):
        raise AssertionError(f"resumed losses {resumed} differ from the "
                             f"uninterrupted run's {tail}")
    if final != ref_run["final"]:
        bad = [p for p in final if ref_run["final"].get(p) != final[p]]
        raise AssertionError(f"after step {WHOLE_TRAIN_STEPS - 1} leaves "
                             f"{bad} differ from the uninterrupted run's")
    check_journal("first life", life1["journal"], life1["durable"],
                  range(WHOLE_FIRST_LIFE), life1["losses"])
    check_journal("second life", journal2, life2["durable"],
                  range(WHOLE_CKPT_EVERY, WHOLE_TRAIN_STEPS), resumed)
    if manifests1 != [(save_rec["lsn"], WHOLE_CKPT_EVERY)] or \
            manifests2 != manifests1 or not save_rec["lsn"] > step2_lsn or \
            not save_rec["end"] >= life1["put_end"]:
        raise AssertionError(f"manifests {manifests1} / {manifests2}: step "
                             f"{WHOLE_CKPT_EVERY}'s not committed after its "
                             f"shards and after step "
                             f"{WHOLE_CKPT_EVERY - 1}'s record "
                             f"(lsn {step2_lsn})")
    if not (life1["no_copy"] and life2["no_copy"]):
        raise AssertionError("the integrity hash copies a grad leaf")
    expect_train_launches("first life", counts1, WHOLE_FIRST_LIFE, cfg,
                          ref_run["n_leaves"])
    expect_train_launches("second life", counts2,
                          WHOLE_TRAIN_STEPS - WHOLE_CKPT_EVERY, cfg,
                          ref_run["n_leaves"])
    if life1["saved_n"] + life1["skipped_n"] != 1:
        raise AssertionError(f"first life: {life1['saved_n']} checkpoints "
                             f"saved + {life1['skipped_n']} skipped, not 1")
    if not max(peak1, peak_restore, peak2) < total:
        raise AssertionError(f"peaks {peak1} / {peak_restore} / {peak2} "
                             f"bytes of {total}")
    return out


def whole_models_phase(seed: int, card: str) -> dict:
    """WHOLE_SERVE's four configs served whole, one after another, then
    qwen2-7b trained whole, once straight through and once through the
    checkpointing trainer's crash and restart; memory back to its start
    between them."""
    # the first products of each kind allocate cuBLAS's workspaces, which
    # stay: make them before the first model's start is read
    for dt in (torch.bfloat16, torch.float32):
        a = torch.ones(64, 64, dtype=dt, device=DEV, requires_grad=True)
        torch.bmm(a[None], a[None]).sum().backward()   # autograd's thread too
    del a
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = {}
    for arch, batch, positions in WHOLE_SERVE:
        t0 = time.perf_counter()
        out[arch] = whole_serving(arch, batch, positions, seed, card)
        out[arch]["phase_s"] = time.perf_counter() - t0
        log(f"phase whole {arch}: {out[arch]['phase_s']:.3f} s")
    t0 = time.perf_counter()
    out["train qwen2-7b"] = whole_train(seed, card)
    out["train qwen2-7b"]["phase_s"] = time.perf_counter() - t0
    log(f"phase whole qwen2-7b train: {out['train qwen2-7b']['phase_s']:.3f} s")
    return out


# --------------------------------------------------------------------- #
# the distributed layer on one card: a one-rank NCCL group
# --------------------------------------------------------------------- #

EP_TOKENS = (8, 4096)               # moonshot's MoE layer: 32,768 tokens
EP_GRAD_ROW_TOL = 2.0 ** -7         # a grad leaf, EP vs dense, of its max
COMPRESS_TOL = 0.02                 # tests/test_distributed.py's bound
PIPE_MICRO, PIPE_MB = 4, (2, 4096)  # mamba2-130m: 4 microbatches of 2 x 4096


def timed_call(fn):
    """(result, ms) of one call, synchronised on both ends."""
    sync = torch.cuda.synchronize if DEV == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def distributed_phase(seed: int, card: str) -> dict:
    """The distributed layer over a one-rank NCCL group (HashStore, rank 0,
    world 1; destroyed at the end, so no later code sees it).  At one rank
    every collective runs its NCCL path and moves no byte over a link: no
    bandwidth is claimed from it.

    EP: one MoE layer of moonshot-v1-16b-a3b at its published width (D
    2048, 64 experts, top-6, F 1408, capacity factor 1.25, bf16), 8 x 4096
    tokens, through ``set_moe_ep`` on the (1, 1) mesh and NCCL's
    all-to-all, forward and backward, against the dense ``moe_ffn`` on the
    same inputs: at one rank the buckets and drops are the dense path's and
    so are the products, so y and aux must be bitwise equal; the grads of
    x, router, wi and wo within 2^-7 of each leaf's largest value (bitwise
    reported).  Compressed all-reduce: that layer's wi gradient in fp32
    (369 M values) through ``quantized_allreduce`` over NCCL, bitwise equal
    to the plain quantize-dequantize and within 0.02 of exact relative to
    its largest value.  Pipeline: ``pipeline_forward`` at one stage whose
    stage is mamba2-130m's 24-block stack at full width in bf16, 4
    microbatches of 2 x 4096, bitwise equal to the stack run on each in
    turn, with 96 SSD scans on the tensor-core route."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import one_rank_group
    from repro_torch.distributed.compression import (
        compressed_psum_reference, quantized_allreduce)
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map

    gen = torch.Generator(device=DEV).manual_seed(seed)
    out = {"card": card}
    with one_rank_group(DEV):
        mesh = make_smoke_mesh(device_type=DEV)
        if tuple(mesh.shape) != (1, 1):
            raise AssertionError(f"smoke mesh on one card: {mesh}")

        # ---- EP vs dense at moonshot's width -------------------------- #
        cfg = get_config("moonshot-v1-16b-a3b")
        out["ep_config"] = describe(cfg, ["one MoE layer of 48, alone"],
                                    card)["config"]
        D, E, F_ = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        bf16 = dict(device=DEV, dtype=torch.bfloat16)

        def draw(*shape, std=0.02):
            return (torch.randn(shape, generator=gen, device=DEV)
                    * std).to(torch.bfloat16)
        x = draw(*EP_TOKENS, D, std=1.0)
        p = {"router": draw(D, E), "experts": {"wi": draw(E, D, 2, F_),
                                               "wo": draw(E, F_, D)}}
        gy = draw(*EP_TOKENS, D, std=1.0)

        def layer(ep: bool):
            leaves = [x.clone().requires_grad_(True)] + [
                t.clone().requires_grad_(True) for t in
                (p["router"], p["experts"]["wi"], p["experts"]["wo"])]
            q = {"router": leaves[1], "experts": {"wi": leaves[2],
                                                  "wo": leaves[3]}}
            L.set_moe_ep(mesh, ("data", "model") if ep else None)
            try:
                y, aux = L.moe_ffn(leaves[0], q, cfg)
                grads = torch.autograd.grad(
                    (y.float() * gy.float()).sum() + aux, leaves)
            finally:
                L.set_moe_ep(None, None)
            return y.detach(), aux.detach(), grads
        runs = {}
        for ep in (False, True, False, True):     # warm, then timed
            runs[ep] = timed_call(lambda: layer(ep))
        (yd, auxd, gd), dense_ms = runs[False]
        (ye, auxe, ge), ep_ms = runs[True]
        C = math.ceil(EP_TOKENS[0] * EP_TOKENS[1] * cfg.experts_per_token
                      / E * cfg.capacity_factor)
        if not (bitwise_equal(ye, yd) and bitwise_equal(auxe, auxd)):
            raise AssertionError(
                f"EP over NCCL at one rank: y max diff "
                f"{float((ye.float() - yd.float()).abs().max())}, aux "
                f"{float(auxe)} vs {float(auxd)}: not the dense path's bits")
        grad_err, grad_bitwise = {}, {}
        for name, a, b in zip(("x", "router", "wi", "wo"), ge, gd):
            err = float((a.float() - b.float()).abs().max()
                        / b.float().abs().max().clamp_min(1e-30))
            grad_err[name], grad_bitwise[name] = err, bitwise_equal(a, b)
            if not err <= EP_GRAD_ROW_TOL:
                raise AssertionError(f"EP grad of {name}: {err} of its max "
                                     f"(tolerance {EP_GRAD_ROW_TOL})")
        out["ep"] = dict(tokens=list(EP_TOKENS), capacity=C,
                         dispatch_buffer_bytes=E * C * D * 2,
                         experts_bytes=(p["experts"]["wi"].numel()
                                        + p["experts"]["wo"].numel()) * 2,
                         y_bitwise=True, aux=float(auxe),
                         grad_rel_err=grad_err, grad_bitwise=grad_bitwise,
                         dense_ms=dense_ms, ep_ms=ep_ms)
        log(f"distributed EP (moonshot MoE layer, {EP_TOKENS} tokens, C "
            f"{C}): y and aux bitwise the dense path's, grads {grad_err} "
            f"(bitwise {grad_bitwise}); forward + backward dense "
            f"{dense_ms:.3f} ms, EP over NCCL {ep_ms:.3f} ms; {card}")

        # ---- the compressed all-reduce on that layer's wi gradient ---- #
        g = ge[2].float()
        del runs, ge, gd
        for _ in range(2):                          # warm, then timed
            got, comp_ms = timed_call(lambda: quantized_allreduce(g, mesh,
                                                                  "data"))
            plain, plain_ms = timed_call(
                lambda: compressed_psum_reference([g]))
        if not bitwise_equal(got, plain):
            raise AssertionError("compressed all-reduce over NCCL is not "
                                 "the plain quantize-dequantize")
        rel = float((got - g).abs().max() / g.abs().max())
        if not rel < COMPRESS_TOL:
            raise AssertionError(f"compressed all-reduce: {rel} of the "
                                 f"largest value (bound {COMPRESS_TOL})")
        out["compressed_allreduce"] = dict(
            values=g.numel(), bitwise_plain=True, rel_err=rel,
            ms=comp_ms, plain_ms=plain_ms)
        log(f"distributed compressed all-reduce ({g.numel()} fp32 values): "
            f"bitwise the plain version, {rel:.3e} of the largest value; "
            f"{comp_ms:.3f} ms, plain {plain_ms:.3f} ms; {card}")
        del g, got, plain

        # ---- a one-stage pipeline of mamba2-130m's stack -------------- #
        mcfg = get_config("mamba2-130m")
        params = M.cast_params(M.init_params(mcfg, gen, device=DEV), mcfg)
        blocks = params["blocks"]

        def stage_fn(bp, h):
            for b in range(mcfg.n_blocks):
                h, _, _ = M.apply_block(tree_map(lambda t: t[b], bp), h,
                                        mcfg)
            return h
        xs = torch.randn((PIPE_MICRO, *PIPE_MB, mcfg.d_model), generator=gen,
                         **bf16)
        def pipeline():
            return pipeline_forward(stage_fn, tree_map(lambda t: t[None],
                                                       blocks), xs,
                                    mesh=mesh, axis="data",
                                    n_micro=PIPE_MICRO)
        with torch.no_grad():
            for _ in range(2):                      # warm, then timed
                want, seq_ms = timed_call(lambda: torch.stack(
                    [stage_fn(blocks, xs[i]) for i in range(PIPE_MICRO)]))
                zero_ssd_counts()
                zero_conv_counts()
                got, pipe_ms = timed_call(pipeline)
                counts, conv = ssd_counts(), conv_counts()
        if not bitwise_equal(got, want):
            raise AssertionError("one-stage pipeline is not the stack run "
                                 "on each microbatch in turn")
        n_scans = PIPE_MICRO * mcfg.n_blocks
        if counts["forward"] != n_scans or \
                counts["tensor_cores"] != n_scans or \
                conv != dict(forward=n_scans, backward=0):
            raise AssertionError(f"pipeline: SSD launches {counts}, conv "
                                 f"{conv}, expected {n_scans} of each, the "
                                 f"scans on the tensor cores")
        out["pipeline"] = dict(
            config=describe(mcfg, [], card)["config"], stages=1,
            micro=PIPE_MICRO, microbatch=list(PIPE_MB), bitwise=True,
            hop="local copy (one stage)", ssd_launches=counts["forward"],
            ssd_tensor_core_launches=counts["tensor_cores"],
            conv_launches=conv["forward"], ms=pipe_ms, sequential_ms=seq_ms)
        log(f"distributed pipeline (mamba2-130m, 1 stage, {PIPE_MICRO} x "
            f"{PIPE_MB}): bitwise the sequential run, {counts['forward']} SSD "
            f"scans on the tensor cores; {pipe_ms:.3f} ms, sequential "
            f"{seq_ms:.3f} ms; {card}")
    return out


CONV_SHAPE = (8, 4096, 1536, 128, 24)   # mamba2-130m: B, S, di, G·ds, nh
CONV_W = 4


def conv_inputs(B, S, di, gds, nh, dtype, seed, shift=0):
    """(the xBC view of an in_proj-shaped output, w [4,C] in its dtype, b
    [C] fp32, state [B,3,C]) on the card from ``seed``; ``shift`` moves the
    view off the mixer's columns (a misaligned view)."""
    C = di + 2 * gds
    gen = torch.Generator(device=DEV).manual_seed(seed)
    r = lambda *s: torch.randn(s, device=DEV, generator=gen)  # noqa: E731
    zxbcdt = r(B, S, 2 * di + 2 * gds + nh + shift).to(dtype)
    return (zxbcdt[..., di + shift:di + shift + C],
            (r(CONV_W, C) / 2).to(dtype), r(C) / 4,
            r(B, CONV_W - 1, C).to(dtype))


def alone_flushed_ms(fn, flush: torch.Tensor, launches: int = 20) -> float:
    """Device time of one call of ``fn`` with a cold L2: a CUDA graph of
    ``launches`` (flush, call) pairs less one of ``launches`` flushes, over
    ``launches``."""
    with_call = kernel_alone_ms(lambda: (flush.zero_(), fn()), launches)
    return with_call - kernel_alone_ms(flush.zero_, launches)


def causal_conv_phase(seed: int) -> dict:
    """The conv kernels (``csrc/causal_conv.cu``) on the card: the forward
    within one bf16 ulp of the fp32 mirror (fp32: 1e-5, fused against
    separate multiply-adds over taps up to about 8) and its new state
    bitwise the plain route's, the gradient against fp32 autograd of the
    plain conv (2^-7 of each gradient's largest value in bf16, 1e-5 in
    fp32) and bitwise on a second call, at mamba2-130m's training shape as
    the mixer's views, a misaligned view (copied first), decode and
    prefill with a state; the pair's time alone (CUDA graph, L2 flushed)
    and per call beside its bytes bound and the plain route's; registers
    and spills (a spill fails).  The launches on the model paths are
    counted where those paths run."""
    from repro_torch.kernels.causal_conv import causal_conv as cc
    from repro_torch.kernels.causal_conv import ref

    def ulps(a, b):
        ia, ib = (t.view(torch.int16).to(torch.int32) for t in (a, b))
        ia = torch.where(ia < 0, -32768 - ia, ia)
        ib = torch.where(ib < 0, -32768 - ib, ib)
        return int((ia - ib).abs().max())

    def grads_fp32(x, w, b, dy, st):
        xf, wf, bf = (t.detach().float().requires_grad_(True)
                      for t in (x, w, b))
        out, _ = ref.causal_conv_fp32_reference(
            xf, wf, bf, None if st is None else st.float())
        return torch.autograd.grad(out, (xf, wf, bf), dy.float())

    out = {"cases": []}
    B, S, di, gds, nh = CONV_SHAPE
    cases = [("train view", (B, S), torch.bfloat16, 0, False),
             ("train view fp32", (B, S), torch.float32, 0, False),
             ("misaligned view", (2, S), torch.bfloat16, 1, False),
             ("prefill with state", (B, 1000), torch.bfloat16, 0, True),
             ("decode", (B, 1), torch.bfloat16, 0, True),
             ("two rows", (B, 2), torch.bfloat16, 0, True)]
    for k, (name, (b_, s_), dtype, shift, with_state) in enumerate(cases):
        x, w, b, st = conv_inputs(b_, s_, di, gds, nh, dtype, seed + k, shift)
        st = st if with_state else None
        if cc.aligned(x) != (shift == 0):
            raise AssertionError(f"conv {name}: read as it lies "
                                 f"{cc.aligned(x)}, expected {shift == 0}")
        n0, n1 = cc.LAUNCHES, cc.BACKWARD_LAUNCHES
        y, new = cc.causal_conv_cuda(x, w, b, st)
        want, plain_state = ref.causal_conv_fp32_reference(x, w, b, st)
        fwd_err = ulps(y, want) if dtype == torch.bfloat16 else \
            float((y - want).abs().max())
        if fwd_err > (1 if dtype == torch.bfloat16 else 1e-5):
            raise AssertionError(f"conv {name}: forward {fwd_err} off the "
                                 f"mirror")
        if with_state and not torch.equal(new, plain_state):
            raise AssertionError(f"conv {name}: new state differs")
        dy = torch.randn(x.shape, device=DEV, generator=torch.Generator(
            device=DEV).manual_seed(seed + 100 + k)).to(dtype)
        grads = cc.causal_conv_backward_cuda(x, w, b, dy, st)
        again = cc.causal_conv_backward_cuda(x, w, b, dy, st)
        if not all(torch.equal(p, q) for p, q in zip(grads, again)):
            raise AssertionError(f"conv {name}: gradient not bitwise repeated")
        tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
        errs = []
        for g_name, got, ref_g in zip(("dx", "dw", "db"), grads,
                                      grads_fp32(x, w, b, dy, st)):
            e = float((got.float() - ref_g).abs().max() /
                      ref_g.abs().max().clamp_min(1e-30))
            errs.append(e)
            if not e <= tol:
                raise AssertionError(f"conv {name}: {g_name} {e:.3e} of its "
                                     f"largest off fp32 autograd ({tol})")
        if (cc.LAUNCHES - n0, cc.BACKWARD_LAUNCHES - n1) != (1, 2):
            raise AssertionError(f"conv {name}: launch counts moved "
                                 f"{cc.LAUNCHES - n0}, "
                                 f"{cc.BACKWARD_LAUNCHES - n1}")
        log(f"conv {name} {tuple(x.shape)} {dtype}: forward "
            f"{fwd_err} {'ulp' if dtype == torch.bfloat16 else 'abs'} off "
            f"the mirror, dx/dw/db {errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e} "
            f"of the largest off fp32 autograd, bitwise repeat")
        out["cases"].append(dict(case=name, shape=list(x.shape),
                                 dtype=str(dtype), fwd_err=fwd_err,
                                 grad_err=errs))
        del x, w, b, st, y, new, want, dy, grads, again

    # times at the training shape, bf16, as the mixer's views
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    x, w, b, _ = conv_inputs(B, S, di, gds, nh, torch.bfloat16, seed)
    dy = torch.randn(x.shape, device=DEV).to(torch.bfloat16)
    nbytes = x.numel() * x.element_size()
    fwd = lambda: cc.causal_conv_cuda(x, w, b)                # noqa: E731
    bwd = lambda: cc.causal_conv_backward_cuda(x, w, b, dy)   # noqa: E731
    xg = x.detach().requires_grad_(True)
    wg = w.detach().requires_grad_(True)
    bg = b.detach().requires_grad_(True)
    plain_out, _ = ref.causal_conv_reference(xg, wg, bg)
    plain_fwd = lambda: ref.causal_conv_reference(x, w, b)    # noqa: E731
    plain_bwd = lambda: torch.autograd.grad(                  # noqa: E731
        plain_out, (xg, wg, bg), dy, retain_graph=True)
    times = dict(
        forward_alone=alone_flushed_ms(fwd, flush),
        forward_call=timed_ms(fwd, 20, flush),
        forward_bound=2 * nbytes / HBM_BYTES_PER_S * 1e3,
        forward_plain=timed_ms(plain_fwd, 10, flush),
        backward_alone=alone_flushed_ms(bwd, flush),
        backward_call=timed_ms(bwd, 20, flush),
        backward_bound=3 * nbytes / HBM_BYTES_PER_S * 1e3,
        backward_plain=timed_ms(plain_bwd, 10, flush))
    for part in ("forward", "backward"):
        log(f"conv {part} {tuple(x.shape)} bf16 view: alone "
            f"{times[part + '_alone']:.6f} ms, a call "
            f"{times[part + '_call']:.6f}, bound "
            f"{times[part + '_bound']:.6f} (bytes), plain "
            f"{times[part + '_plain']:.6f}")
    out["times_ms"] = times
    del x, w, b, dy, xg, wg, bg, plain_out, flush

    info = []
    for dtype in cc.DTYPES:
        for kinfo in cc.kernel_info(CONV_W, dtype):
            kinfo.update(dtype=str(dtype))
            info.append(kinfo)
            log(f"conv {kinfo['launch']} kernel {dtype}: "
                f"{kinfo['registers']} registers, "
                f"{kinfo['local_bytes']} local bytes, "
                f"{kinfo['static_shared_bytes']} shared bytes")
            if kinfo["local_bytes"]:
                raise AssertionError(f"conv kernel spills: {kinfo}")
    out["kernel_info"] = info
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phase", choices=["all", "ssd", "ssd_backward", "flash",
                                        "flash_backward", "causal_conv",
                                        "distributed", "whole_models",
                                        "faults"],
                    default="all",
                    help="ssd / ssd_backward / flash / flash_backward / "
                         "causal_conv / distributed / whole_models / faults: "
                         "build, run that phase alone and print its JSON, "
                         "for work on the SSD scan or its gradient, the "
                         "flash forward or backward kernels, the mixer's "
                         "conv kernels, the distributed layer, the configs "
                         "served and trained whole, or the log's fault "
                         "paths")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.log import REC_HDR_SIZE
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.causal_conv import causal_conv
    from repro_torch.kernels.checksum import checksum
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan

    # fp32 on the card in full fp32: no TF32 in matmuls or convolutions;
    # bf16 products summed in fp32, as the JAX package's reference does
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    t0 = t_run = time.perf_counter()
    sources = [checksum.SOURCE, ssd_scan.SOURCE, ssd_scan.TC_SOURCE,
               ssd_scan.BWD_SOURCE, ssd_scan.BWD_TC_SOURCE,
               flash_attention.SOURCE, flash_attention.BWD_SOURCE,
               flash_attention.BWD_TC_SOURCE, causal_conv.SOURCE]
    with ThreadPoolExecutor(len(sources)) as pool:   # one nvcc per source
        list(pool.map(nvcc.build, sources))         # re-raises a failure
    build_s = time.perf_counter() - t0
    log(card)                    # nvidia-smi's "name, power.limit" line
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    log(f"kernel build (nvcc, sm_90a, {len(sources)} sources in parallel): "
        f"{build_s:.3f} s")

    if args.phase == "ssd":
        t0 = time.perf_counter()
        ssd_out = ssd_kernel_phase(args.seed)
        log(f"phase ssd: {time.perf_counter() - t0:.3f} s")
        print(json.dumps({"ssd": ssd_out}))
        return 0
    if args.phase == "ssd_backward":
        print(json.dumps({"ssd_backward": ssd_backward_phase(args.seed)}))
        return 0
    if args.phase == "flash":
        t0 = time.perf_counter()
        flash_out = flash_kernel_phase(args.seed)
        log(f"phase flash: {time.perf_counter() - t0:.3f} s")
        print(json.dumps({"flash": flash_out,
                          "flash_kernel_attributes": flash_attributes()}))
        return 0
    if args.phase == "flash_backward":
        t0 = time.perf_counter()
        bwd_out = flash_backward_phase(args.seed)
        log(f"phase flash backward: {time.perf_counter() - t0:.3f} s")
        print(json.dumps({"flash_backward": bwd_out}))
        return 0
    if args.phase == "causal_conv":
        t0 = time.perf_counter()
        conv_out = causal_conv_phase(args.seed)
        log(f"phase causal conv: {time.perf_counter() - t0:.3f} s")
        print(json.dumps({"causal_conv": conv_out}))
        return 0
    if args.phase == "distributed":
        t0 = time.perf_counter()
        dist_out = distributed_phase(args.seed, card)
        log(f"phase distributed: {time.perf_counter() - t0:.3f} s")
        print(json.dumps({"distributed": dist_out}))
        return 0
    if args.phase == "whole_models":
        print(json.dumps({"whole_models": whole_models_phase(args.seed,
                                                             card)}))
        return 0

    base = np.random.default_rng(args.seed).integers(
        0, 256, 1 << 22, dtype=np.uint8).tobytes()
    if args.phase == "faults":
        print(json.dumps({"faults": faults_phase(base, args.seed)}))
        return 0
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
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
    faults = faults_phase(base, args.seed)
    ssd = ssd_kernel_phase(args.seed)
    serving = serving_phase(args.seed)
    cross = card_vs_cpu_phase(serving.pop("restored"), args.seed)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ssd_bwd = ssd_backward_phase(args.seed)
    log(f"phase ssd backward: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    conv = causal_conv_phase(args.seed)
    log(f"phase causal conv: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    train = train_phase(args.seed, card)
    log(f"phase train: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    train_cpu = train_card_vs_cpu_phase(args.seed)
    log(f"phase train card vs cpu: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    flash = flash_kernel_phase(args.seed)
    log(f"phase flash: {time.perf_counter() - t0:.3f} s")
    flash_attrs = flash_attributes()
    for a in flash_attrs:
        log(f"flash kernel {a['dtype']} D={a['head_dim']} Dv={a['v_head_dim']}"
            f"{' softcap' if a['softcap'] else ''} ({a['route']}): "
            f"{a['registers']} registers, {a['local_bytes']} local bytes, "
            f"{a['shared_bytes']} shared bytes, {a['threads']} threads")
    t0 = time.perf_counter()
    flash_bwd = flash_backward_phase(args.seed)
    log(f"phase flash backward: {time.perf_counter() - t0:.3f} s")
    attn_train, attn_cpu = {}, {}
    for arch, *_ in ATTN_TRAIN:
        t0 = time.perf_counter()
        attn_train[arch] = attention_train_phase(arch, args.seed, card)
        log(f"phase train {arch}: {time.perf_counter() - t0:.3f} s")
    for arch, *_ in ATTN_CPU:
        t0 = time.perf_counter()
        attn_cpu[arch] = attention_card_vs_cpu_phase(arch, args.seed)
        log(f"phase train card vs cpu {arch}: {time.perf_counter() - t0:.3f} s")
    gemma = gemma2_serving_phase(args.seed)
    gemma_cpu = gemma2_card_vs_cpu_phase(args.seed)
    t0 = time.perf_counter()
    deepseek = deepseek_serving_phase(args.seed, card)
    log(f"phase deepseek-v3: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    deepseek_cpu = deepseek_card_vs_cpu_phase(args.seed)
    log(f"phase deepseek-v3 card vs cpu: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    hubert = hubert_phase(args.seed, card)
    log(f"phase hubert-xlarge: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    llava = llava_phase(args.seed, card)
    log(f"phase llava-next-34b: {time.perf_counter() - t0:.3f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    distributed = distributed_phase(args.seed, card)
    distributed["phase_s"] = time.perf_counter() - t0
    log(f"phase distributed: {distributed['phase_s']:.3f} s")
    whole = whole_models_phase(args.seed, card)

    at = kern[f"batch({main_rows},259) 1GiB ring"]
    new_paths = [health["scrub_launches"], health["second_pass_launches"],
                 health["replay_launches"], resync["gap_launches"],
                 resync["rebuild_launches"], router["fill_launches"],
                 router["recover_launches"], faults["launches"]]
    main_launches = (main["fill_launches"] + main["recovery_launches"]
                     + main["rebuild_launches"]
                     + sum(c["launches"] for c in new_paths))
    short = (main["fill_short_row_launches"]
             + main["recovery_short_row_launches"]
             + main["rebuild_short_row_launches"]
             + sum(c["short_rows"] for c in new_paths))
    whole_train = whole["train qwen2-7b"]
    restart = whole_train["checkpoint_restart"]
    lives = [restart["first_life"]["launches"],
             restart["second_life"]["launches"]]
    restart_hash = {k: sum(c["hash"][k] for c in lives)
                    for k in ("launches", "short_rows", "long_rows")}
    train_hash = {k: train["main_path_counts"]["hash"][k]
                  + whole_train["launches"]["hash"][k] + restart_hash[k]
                  for k in ("launches", "short_rows", "long_rows")}
    kernels = [dict(
        name="checksum_rows", route="cuda",
        source="src/repro_torch/csrc/checksum.cu",
        replaces="src/repro/kernels/checksum/checksum.py:30",
        launches=main_launches + train_hash["launches"],
        launches_by_route={
            "short_rows": short + train_hash["short_rows"],
            "long_rows": main_launches - short + train_hash["long_rows"]},
        launches_by_path={
            "log": main_launches,
            "log faults": faults["launches"]["launches"],
            "train": train["main_path_counts"]["hash"]["launches"],
            "train qwen2-7b whole": whole_train["launches"]["hash"][
                "launches"],
            "train qwen2-7b checkpointing trainer": restart_hash["launches"]},
        max_abs_err=max(r["max_abs_err"] for r in kern.values()
                        if "max_abs_err" in r),
        ms=at["kernel_alone_ms"], wrapper_ms=at["ms"],
        plain_ms=at["plain_ms"], bound_ms=at["bound_ms"],
        bound_by=at["bound_by"], library_ms=None)]
    serve_at = ssd[f"ssd{SSD_SERVE} bfloat16 mixer views"]
    turns = serve_at["layouts"]
    train_ssd = train["main_path_counts"]["ssd"]
    pipe = distributed["pipeline"]
    kernels.append(dict(
        name="ssd_scan", route="cuda", forward_route="tensor_cores",
        source="src/repro_torch/csrc/ssd_scan_tc.cu",
        replaces="src/repro/kernels/ssd_scan/ssd_scan.py:29",
        launches=(serving["ssd_launches"] + train_ssd["forward"]
                  + pipe["ssd_launches"]),
        launches_by_route={
            "tensor_cores": (serving["ssd_tensor_core_launches"]
                             + train_ssd["tensor_cores"]
                             + pipe["ssd_tensor_core_launches"]),
            "cuda_cores": (serving["ssd_launches"]
                           - serving["ssd_tensor_core_launches"]
                           + train_ssd["cuda_cores"])},
        launches_by_path={"serving": serving["ssd_launches"],
                          "train": train_ssd["forward"],
                          "pipeline": pipe["ssd_launches"]},
        max_abs_err=max(r["max_abs_err"] for k, r in ssd.items()
                        if k != "kernel_info"
                        and r["route"] == "tensor_cores"),
        ms=float(np.median(turns["mixer views"]["alone_ms"])),
        wrapper_ms=serve_at["ms"],
        contiguous_ms=float(np.median(turns["contiguous"]["alone_ms"])),
        plain_ms=serve_at["plain_ms"],
        bound_ms=serve_at["bound_ms"], bound_by=serve_at["bound_by"],
        library_ms=None))
    scan_cc = ssd[f"ssd{SSD_SERVE} float32"]
    scan_cc_launches = {"card vs cpu": cross["ssd_cuda_core_launches"],
                        "train card vs cpu": train_cpu["ssd_counts"][
                            "cuda_cores"]}
    kernels.append(dict(
        name="ssd_scan_cuda_cores", route="cuda", forward_route="cuda_cores",
        source="src/repro_torch/csrc/ssd_scan.cu",
        kernel="three launches on mma.sync: fp32 as three TF32 products, "
               "bf16 with the tensor-core route's roundings",
        replaces="src/repro/kernels/ssd_scan/ssd_scan.py:29",
        launches=sum(scan_cc_launches.values()),
        launches_by_path=scan_cc_launches,
        max_abs_err=max(r["max_abs_err"] for k, r in ssd.items()
                        if k != "kernel_info" and r["route"] == "cuda_cores"),
        ms=scan_cc["alone_ms"], wrapper_ms=scan_cc["ms"],
        launch_ms=scan_cc["launch_ms"], plain_ms=scan_cc["plain_ms"],
        bound_ms=scan_cc["bound_ms"], bound_by=scan_cc["bound_by"],
        bound_fp32_rate_ms=scan_cc["bound_fp32_rate_ms"],
        mirror_rel_err=scan_cc["mirror_rel_err"], library_ms=None))
    bwd_tc = ssd_bwd[f"ssd_bwd{SSD_TRAIN} bfloat16 mixer views"]
    bwd_cc = ssd_bwd[f"ssd_bwd{SSD_TRAIN} float32"]
    bwd_cc16 = ssd_bwd[f"ssd_bwd{SSD_TRAIN} bfloat16 misaligned"]
    bwd_cases = [r for k, r in ssd_bwd.items() if k != "kernel_info"]
    gradient_of = ("src/repro/kernels/ssd_scan/ref.py:24 (jax.grad; the "
                   "Pallas kernel has no gradient)")
    kernels.append(dict(
        name="ssd_scan_backward", route="cuda", backward_route="tensor_cores",
        source="src/repro_torch/csrc/ssd_scan_bwd_tc.cu",
        replaces="src/repro/kernels/ssd_scan/ssd_scan.py:29",
        gradient_of=gradient_of,
        launches=train_ssd["backward_tensor_cores"],
        max_abs_err=max(r["max_abs_err"] for r in bwd_cases
                        if r["route"] == "tensor_cores"),
        ms=bwd_tc["alone_ms"], wrapper_ms=bwd_tc["ms"],
        launch_ms=bwd_tc["launch_ms"], plain_ms=bwd_tc["plain_ms"],
        plain_autograd_ms=bwd_tc["plain_autograd_ms"],
        bound_ms=bwd_tc["bound_ms"], bound_by=bwd_tc["bound_by"],
        library_ms=None))
    kernels.append(dict(
        name="ssd_scan_backward_cuda_cores", route="cuda",
        backward_route="cuda_cores",
        source="src/repro_torch/csrc/ssd_scan_bwd.cu",
        replaces="src/repro/kernels/ssd_scan/ssd_scan.py:29",
        gradient_of=gradient_of,
        launches=train_cpu["ssd_counts"]["backward_cuda_cores"],
        max_abs_err=max(r["max_abs_err"] for r in bwd_cases
                        if r["route"] == "cuda_cores"),
        ms=bwd_cc["alone_ms"], wrapper_ms=bwd_cc["ms"],
        launch_ms=bwd_cc["launch_ms"], plain_ms=bwd_cc["plain_ms"],
        plain_autograd_ms=bwd_cc["plain_autograd_ms"],
        bound_ms=bwd_cc["bound_ms"], bound_by=bwd_cc["bound_by"],
        bound_fp32_rate_ms=bwd_cc["bound_fp32_rate_ms"],
        bf16_ms=bwd_cc16["alone_ms"], bf16_wrapper_ms=bwd_cc16["ms"],
        bf16_launch_ms=bwd_cc16["launch_ms"],
        bf16_bound_ms=bwd_cc16["bound_ms"], library_ms=None))
    conv_t = conv["times_ms"]
    conv_fwd_by_path = {
        "serving": serving["conv_launches"]["forward"],
        "card vs cpu": cross["conv_launches"],
        "train": train["main_path_counts"]["conv"]["forward"],
        "train card vs cpu": train_cpu["conv_counts"]["forward"],
        "pipeline": pipe["conv_launches"]}
    conv_bwd_by_path = {
        "train": train["main_path_counts"]["conv"]["backward"],
        "train card vs cpu": train_cpu["conv_counts"]["backward"]}
    kernels.append(dict(
        name="causal_conv", route="cuda",
        source="src/repro_torch/csrc/causal_conv.cu",
        kernel="causal_conv_fwd_kernel; gradient causal_conv_bwd_kernel + "
               "causal_conv_wsum_kernel",
        replaces="src/repro/models/layers.py:594 (_causal_conv, XLA-fused; "
                 "no TPU kernel)",
        launches=sum(conv_fwd_by_path.values()),
        launches_by_path=conv_fwd_by_path,
        backward_launches=sum(conv_bwd_by_path.values()),
        backward_launches_by_path=conv_bwd_by_path,
        max_fwd_err=max(c["fwd_err"] for c in conv["cases"]),
        max_grad_rel_err=max(max(c["grad_err"]) for c in conv["cases"]),
        ms=conv_t["forward_alone"], wrapper_ms=conv_t["forward_call"],
        plain_ms=conv_t["forward_plain"], bound_ms=conv_t["forward_bound"],
        bound_by="bytes", backward_ms=conv_t["backward_alone"],
        backward_wrapper_ms=conv_t["backward_call"],
        backward_plain_ms=conv_t["backward_plain"],
        backward_bound_ms=conv_t["backward_bound"], library_ms=None))
    flash_at = flash["gemma2 global (2, 16, 8, 8192, 256) bfloat16"]
    by_path = {"gemma2-9b": dict(
        all=gemma["flash_launches"],
        tensor_cores=gemma["flash_tensor_core_launches"],
        cuda_cores=gemma["flash_launches"]
        - gemma["flash_tensor_core_launches"]),
        "deepseek-v3-671b": deepseek["flash"],
        "hubert-xlarge": hubert["flash"], "llava-next-34b": llava["flash"]}
    for arch, r in attn_train.items():
        c = r["main_path_counts"]
        by_path[f"train {arch}"] = {k: c[k] for k in ("all", "tensor_cores",
                                                      "cuda_cores")}
    for arch, *_ in WHOLE_SERVE:
        by_path[f"{arch} whole"] = whole[arch]["flash"]
    by_path["train qwen2-7b whole"] = {
        k: whole_train["launches"][k] for k in ("all", "tensor_cores",
                                                "cuda_cores")}
    by_path["train qwen2-7b checkpointing trainer"] = {
        k: sum(c[k] for c in lives) for k in ("all", "tensor_cores",
                                              "cuda_cores")}

    def shape_times(key):
        r = flash[key]
        return {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")}
    kernels.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:35",
        launches=sum(c["all"] for c in by_path.values()),
        launches_by_route={r: sum(c[r] for c in by_path.values())
                           for r in ("tensor_cores", "cuda_cores")},
        launches_by_path=by_path,
        max_abs_err=max(r["max_abs_err"] for r in flash.values()),
        ms=flash_at["ms"], plain_ms=flash_at["plain_ms"],
        bound_ms=flash_at["bound_ms"], bound_by=flash_at["bound_by"],
        library_ms=flash_at["library_ms"],
        mla_shape=shape_times(f"mla {MLA} dv {MLA_DV} bfloat16"),
        hubert_shape=shape_times(f"hubert {HUBERT} bfloat16"),
        llava_shape=shape_times(f"llava {LLAVA} bfloat16")))
    fwd_cc = {k: r for k, r in flash.items() if r["route"] == "cuda_cores"}
    fwd_cc_at = flash[f"gemma2 global {G2} float32"]
    kernels.append(dict(
        name="flash_attention_cuda_cores", route="cuda",
        forward_route="cuda_cores",
        source="src/repro_torch/csrc/flash_attention.cu",
        kernel="flash_fwd_kernel (mma.sync: fp32 as three TF32 products, "
               "bf16 products; the route TMA cannot take)",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:35",
        launches=sum(r["flash_counts"]["cuda_cores"]
                     for r in attn_cpu.values()),
        launches_by_path={f"{arch} card vs cpu": r["flash_counts"][
            "cuda_cores"] for arch, r in attn_cpu.items()},
        max_abs_err=max(r["max_abs_err"] for r in fwd_cc.values()),
        ms=fwd_cc_at["alone_ms"], wrapper_ms=fwd_cc_at["ms"],
        plain_ms=fwd_cc_at["plain_ms"], bound_ms=fwd_cc_at["bound_ms"],
        bound_by=fwd_cc_at["bound_by"], library_ms=fwd_cc_at["library_ms"],
        shapes={k: {f: r[f] for f in (
            "ms", "alone_ms", "plain_ms", "bound_ms", "bound_by", "library",
            "library_ms", "registers", "local_bytes", "row_rel_err",
            "mirror_row_rel_err")} for k, r in fwd_cc.items()}))
    bwd_at = flash_bwd[f"gemma2 global {G2T} bfloat16"]
    bwd_cc = flash_bwd[f"hubert {HUBERT} float32"]
    bwd_cc16 = flash_bwd[f"starcoder2 {SC2} misaligned bfloat16"]
    bwd_cases = {k: r for k, r in flash_bwd.items() if k != "kernel_info"}
    bwd_by_path = {arch: r["main_path_counts"]["backward_tensor_cores"]
                   for arch, r in attn_train.items()}
    bwd_by_path["qwen2-7b whole"] = whole_train["launches"][
        "backward_tensor_cores"]
    bwd_by_path["qwen2-7b checkpointing trainer"] = sum(
        c["backward_tensor_cores"] for c in lives)
    bwd_cc_by_path = {f"{arch} card vs cpu": r["flash_counts"][
        "backward_cuda_cores"] for arch, r in attn_cpu.items()}
    gradient_of = ("src/repro/kernels/flash_attention/ref.py:20 (jax.grad; "
                   "the Pallas kernel has no gradient)")

    def bwd_times(key):
        r = flash_bwd[key]
        return {k: r[k] for k in ("route", "ms", "alone_ms", "launch_ms",
                                  "plain_ms", "bound_ms", "bound_by",
                                  "executed_over_needed", "library",
                                  "library_ms")}
    kernels.append(dict(
        name="flash_attention_backward", route="cuda",
        backward_route="tensor_cores",
        source="src/repro_torch/csrc/flash_attention_bwd_tc.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:35",
        gradient_of=gradient_of, launches=sum(bwd_by_path.values()),
        kernels_a_call=3, launches_by_path=bwd_by_path,
        max_abs_err=max(r["max_abs_err"] for r in bwd_cases.values()
                        if r["route"] == "tensor_cores"),
        ms=bwd_at["alone_ms"], wrapper_ms=bwd_at["ms"],
        launch_ms=bwd_at["launch_ms"], plain_ms=bwd_at["plain_ms"],
        bound_ms=bwd_at["bound_ms"], bound_by=bwd_at["bound_by"],
        library_ms=bwd_at["library_ms"],
        shapes={k: bwd_times(k) for k, r in bwd_cases.items()
                if r["route"] == "tensor_cores"}))
    kernels.append(dict(
        name="flash_attention_backward_cuda_cores", route="cuda",
        backward_route="cuda_cores",
        source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:35",
        gradient_of=gradient_of, launches=sum(bwd_cc_by_path.values()),
        kernels_a_call=3, launches_by_path=bwd_cc_by_path,
        max_abs_err=max(r["max_abs_err"] for r in bwd_cases.values()
                        if r["route"] == "cuda_cores"),
        ms=bwd_cc["alone_ms"], wrapper_ms=bwd_cc["ms"],
        launch_ms=bwd_cc["launch_ms"], plain_ms=bwd_cc["plain_ms"],
        bound_ms=bwd_cc["bound_ms"], bound_by=bwd_cc["bound_by"],
        library_ms=bwd_cc["library_ms"],
        bf16_ms=bwd_cc16["alone_ms"], bf16_wrapper_ms=bwd_cc16["ms"],
        shapes={k: bwd_times(k) for k, r in bwd_cases.items()
                if r["route"] == "cuda_cores"}))
    print(json.dumps({"shapes": kern, "main_path": main, "health": health,
                      "trim_resync": resync, "router_kv": router,
                      "faults": faults,
                      "ssd_shapes": ssd,
                      "serving": serving, "card_vs_cpu": cross,
                      "ssd_backward_shapes": ssd_bwd, "causal_conv": conv,
                      "train": train,
                      "train_card_vs_cpu": train_cpu,
                      "flash_shapes": flash, "gemma2_serving": gemma,
                      "gemma2_card_vs_cpu": gemma_cpu,
                      "deepseek_serving": deepseek,
                      "deepseek_card_vs_cpu": deepseek_cpu,
                      "hubert": hubert, "llava": llava,
                      "flash_backward_shapes": flash_bwd,
                      "attention_train": attn_train,
                      "attention_train_card_vs_cpu": attn_cpu,
                      "distributed": distributed, "whole_models": whole}))
    print(json.dumps({"flash_kernel_attributes": flash_attrs}))
    log(f"chip_smoke: the whole run {time.perf_counter() - t_run:.1f} s, "
        f"the build included")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
