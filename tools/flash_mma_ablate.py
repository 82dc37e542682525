#!/usr/bin/env python3
"""Where the mma.sync flash kernels' time goes (the ``cuda_cores`` route).

    python3 tools/flash_mma_ablate.py [--reps N]

Builds variants of ``src/repro_torch/csrc/flash_attention.cu`` and
``flash_attention_bwd.cu``, each the source with one part of the work
taken out (the outputs are then wrong; only the time is read), and times
them in two rounds of opposite order:

  forward   base, no_qk (no Q·Kᵀ products), no_pv (no P·V products),
            no_exp (the softmax's expf left out), no_copy (no K/V tile
            after the first is copied)
  backward  base, no_scores (no S or dP: the phase before shared memory),
            no_products (no dV, dK or dQ: the phase after it), no_dp (no
            fp32 dP FMAs), no_copy (no tile after the first is copied)

at fp32 qwen2-7b width (2, 28, 4, 8192, 128, causal) and gemma2-9b's
global layer (2, 16, 8, 8192, 256, causal, softcap 50) forward, hubert's
encoder (8, 16, 16, 1500, 80) fp32 backward, and starcoder2's prefill
(2, 24, 2, 4096, 128, causal) as bf16 copies 8 bytes off 16-byte
alignment, forward and backward.  Each variant is built with the
kernels' nvcc flags (all in parallel) and loaded in place of the
kernel's library; a time is the median of --reps calls between CUDA
events.  Prints the card's ``name, power.limit`` line, then one JSON line
a case.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from ablate_common import card as card_line, median_ms, variant

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

FORWARD = {
    "base": [],
    "no_qk": [("scores<NT>(s, Qs, Ks, ldk, m0, nk, lane);", "")],
    "no_pv": [("pv<NT, NO>(o, s, Vs, ldv, nv, lane);", "")],
    "no_exp": [("const float p = expf(s[nt][e] - m_new[e >> 1]);",
                "const float p = s[nt][e] - m_new[e >> 1];")],
    "no_copy": [("      issue(kt + 1, st ^ 1);\n", "")],
}
BACKWARD = {
    "base": [],
    "no_scores": [("  if (seen) {\n    const int nk", "  if (false) {\n    const int nk")],
    "no_products": [
        ("      mma_tn<NTB>(dv, Ps, ldp, 16 * wk, dOs, ldv, n0, Bq, a.Dv, lane);\n"
         "      mma_tn<NTB>(dk, dSs, ldp, 16 * wk, Qs, ldk, n0, Bq, a.D, lane);\n", ""),
        ("      mma_tn<NTB>(dv, Ps, nullptr, ldp, 16 * wk, dOs, ldv, n0, Bq, a.Dv, lane);\n"
         "      mma_tn<NTB>(dk, dSs, dSs_lo, ldp, 16 * wk, Qs, ldk, n0, Bq, a.D, lane);\n", ""),
        ("      mma_tn<NTB>(dq, dSt, ldp, 16 * wr, K, ldk, wn * (DM / WC), Bk, a.D, lane);\n", ""),
        ("      mma_tn<NTB>(dq, dSt, dSt_lo, ldp, 16 * wr, K, ldk, wn * (DM / WC), Bk, a.D, "
         "lane);\n", "")],
    "no_dp": [("dots_fp32<NT>(dp, dOs, ldv, m0, Vs, ldv, n0, a.Dv, lane);", "")],
    "no_copy": [("      issue(i + 1, st ^ 1);\n", ""), ("      issue(kt + 1, st ^ 1);\n", "")],
}


def inputs(shape, dtype, shifted: bool):
    """q, k, v and dO from a fixed seed; "shifted": copies 4 elements past
    the allocation's start."""
    import torch

    B, H, KV, S, D = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for s in ((B, H, S, D), (B, KV, S, D), (B, KV, S, D), (B, H, S, D)):
        t = torch.randn(s, device="cuda", generator=gen).to(dtype)
        if shifted:
            buf = torch.empty(t.numel() + 4, dtype=dtype, device="cuda")
            t = buf[4:].view(s).copy_(t)
        out.append(t)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_mma_ablate: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.flash_attention import flash_attention as fa

    card = card_line()
    print(card, flush=True)
    jobs = [(fa.SOURCE, n, s) for n, s in FORWARD.items()] + \
        [(fa.BWD_SOURCE, n, s) for n, s in BACKWARD.items()]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: variant(j[0], "ablate_mma", *j[1:]),
                              jobs))
    fwd = dict(zip(FORWARD, built[:len(FORWARD)]))
    bwd = dict(zip(BACKWARD, built[len(FORWARD):]))
    source, bwd_source = fa.SOURCE, fa.BWD_SOURCE
    cases = [("forward", "qwen2 width fp32", (2, 28, 4, 8192, 128), torch.float32,
              False, dict(causal=True)),
             ("forward", "gemma2 global fp32", (2, 16, 8, 8192, 256), torch.float32,
              False, dict(causal=True, cap=50.0)),
             ("forward", "starcoder2 misaligned bf16", (2, 24, 2, 4096, 128),
              torch.bfloat16, True, dict(causal=True)),
             ("backward", "hubert fp32", (8, 16, 16, 1500, 80), torch.float32,
              False, dict(causal=False)),
             ("backward", "starcoder2 misaligned bf16", (2, 24, 2, 4096, 128),
              torch.bfloat16, True, dict(causal=True))]
    try:
        for kind, name, shape, dtype, shifted, kw in cases:
            q, k, v, do = inputs(shape, dtype, shifted)
            fa.SOURCE, fa.BWD_SOURCE = source, bwd_source
            o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
            variants = fwd if kind == "forward" else bwd
            times = {n: [] for n in variants}
            for order in (list(variants), list(variants)[::-1]):
                for n in order:
                    if kind == "forward":
                        fa.SOURCE = variants[n]
                        fn = lambda: fa.flash_attention_cuda(q, k, v, **kw)  # noqa: E731
                    else:
                        fa.BWD_SOURCE = variants[n]
                        fn = lambda: fa.flash_attention_backward_cuda(  # noqa: E731
                            q, k, v, o, lse, do, **kw)
                    times[n].append(median_ms(fn, args.reps))
            print(json.dumps({"kind": kind, "case": name, "shape": list(shape),
                              "dtype": str(dtype).removeprefix("torch."),
                              "options": kw, "card": card,
                              "ms": {n: t for n, t in times.items()}}), flush=True)
            del q, k, v, do, o, lse
            torch.cuda.empty_cache()
    finally:
        fa.SOURCE, fa.BWD_SOURCE = source, bwd_source
    return 0


if __name__ == "__main__":
    sys.exit(main())
