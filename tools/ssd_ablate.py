#!/usr/bin/env python3
"""Where the SSD scan's ``cuda_cores`` kernels spend their time.

    python3 tools/ssd_ablate.py [--reps N]

Builds variants of ``src/repro_torch/csrc/ssd_scan.cu`` and
``ssd_scan_bwd.cu``, each the source with one part of the work taken out
(the outputs are then wrong; only the time is read), and times them in
two rounds of opposite order:

  base          the source as it is
  no_products   the mma.sync instructions emptied (fragments still loaded)
  no_split      no staged slice split into its operand planes (the
                landed values are not read either)
  no_landing    no slice landed from global memory (zeros stored instead)

at mamba2-130m's shapes: the fp32 scan at (8, 4096, 24, 64, 1, 128, 256)
and its fp32 gradient there, and the gradient of bf16 copies one element
off 16-byte alignment (plain loads instead of cp.async).  Then aligned
bf16, which ``route`` sends to the tensor-core sources: the scan and its
gradient at the same shape, forced onto the ``cuda_cores`` sources (their
variants as above) and timed beside the tensor-core route's own call
("tensor_cores"), so the two bf16 sources of one algorithm are compared
on the same inputs.  Each variant is built with the kernels' nvcc flags
(all in parallel) and loaded in place of the kernel's library; a time is
the median of --reps calls between CUDA events.  Prints the card's
``name, power.limit`` line, then one JSON line a case.  Needs a CUDA card.
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

SHAPE = (8, 4096, 24, 64, 1, 128, 256)
VARIANTS = {
    "base": [],
    "no_products": [
        ('"mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "\n'
         '      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, '
         '{%0, %1, %2, %3};\\n"', '""'),
        ('"mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "\n'
         '      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, '
         '{%0, %1, %2, %3};\\n"', '""')],
    "no_split": [
        ("      put4(dst, r * kLd + c, plane, v);\n", ""),
        ("      for (int q = 0; q < 4; ++q) put(dst, (c + q) * kLd + k, plane, "
         "v[q]);\n", ""),
        ("      put4<kHL>(dst, r * kLd + c, plane, v);\n", ""),
        ("        if (kHL)\n"
         "          put_hl(dst, (c + q) * kLd + k, plane, v[q]);\n"
         "        else\n"
         "          put(dst, (c + q) * kLd + k, plane, v[q]);\n", "")],
    "no_landing": [
        ("        cp_async16(d, src + r * stride + q * kV);\n", "        ;\n"),
        ("      raw[r * ld + c] = (r < nr && c < ncv) ? src[r * stride + c] "
         ": from_f32<Ts>(0.f);\n", "      raw[r * ld + c] = from_f32<Ts>(0.f);\n")],
}


def inputs(dtype, shifted: bool):
    """xh, dt, A_log, Bm, Cm and dy at SHAPE from a fixed seed (dt and A as
    mamba2-130m initialises them); "shifted": xh, Bm, Cm and dy copied one
    element past the allocation's start."""
    import torch

    B, S, H, P, G, N, _ = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)

    def draw(*s):
        t = torch.randn(s, device="cuda", generator=gen).to(dtype)
        if shifted:
            t = torch.empty(t.numel() + 1, dtype=dtype,
                            device="cuda")[1:].view(s).copy_(t)
        return t
    dt = torch.rand(B, S, H, device="cuda", generator=gen) * 0.099 + 1e-3
    A_log = torch.log(torch.rand(H, device="cuda", generator=gen) * 15 + 1)
    return (draw(B, S, H, P), dt, A_log, draw(B, S, G, N), draw(B, S, G, N),
            draw(B, S, H, P))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ssd_ablate: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.ssd_scan import ssd_scan

    card = card_line()
    print(card, flush=True)
    # the two sources stage alike but not in the same words (only the
    # gradient splits bf16 into hi and lo): each substitution must match
    # one source at least, and each variant change both
    sources = (ssd_scan.SOURCE, ssd_scan.BWD_SOURCE)
    text = "".join(src.read_text() for src in sources)
    for n, subs in VARIANTS.items():
        missing = [old[:60] for old, _ in subs if old not in text]
        if missing:
            raise RuntimeError(f"{n}: no source has {missing}")
    jobs = []
    for src in sources:
        for n, subs in VARIANTS.items():
            own = [(old, new) for old, new in subs if old in src.read_text()]
            if subs and not own:
                raise RuntimeError(f"{n}: nothing of {src.name} matched")
            jobs.append((src, "ablate_ssd", n, own))
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: variant(*j), jobs))
    fwd = dict(zip(VARIANTS, built[:len(VARIANTS)]))
    bwd = dict(zip(VARIANTS, built[len(VARIANTS):]))
    source, bwd_source = ssd_scan.SOURCE, ssd_scan.BWD_SOURCE
    route, backward_route = ssd_scan.route, ssd_scan.backward_route
    chunk = SHAPE[-1]
    # (kind, case, dtype, shifted, forced onto the cuda_cores sources)
    cases = [("scan", "fp32", torch.float32, False, False),
             ("gradient", "fp32", torch.float32, False, False),
             ("gradient", "misaligned bf16", torch.bfloat16, True, False),
             ("scan", "aligned bf16", torch.bfloat16, False, True),
             ("gradient", "aligned bf16", torch.bfloat16, False, True)]

    def on_cuda_cores(*_):
        return "cuda_cores"
    try:
        for kind, name, dtype, shifted, forced in cases:
            xh, dt, A_log, Bm, Cm, dy = inputs(dtype, shifted)
            natural = route(xh, Bm, Cm, chunk) if kind == "scan" else \
                backward_route(xh, Bm, Cm, dy, chunk)
            if natural != ("tensor_cores" if forced else "cuda_cores"):
                raise AssertionError(f"{name} {kind}: route {natural}")
            variants = dict(fwd if kind == "scan" else bwd)
            if forced:
                variants["tensor_cores"] = None
            times = {n: [] for n in variants}
            for order in (list(variants), list(variants)[::-1]):
                for n in order:
                    tc = variants[n] is None    # the tensor-core route
                    ssd_scan.route = route if tc else on_cuda_cores
                    ssd_scan.backward_route = backward_route if tc else \
                        on_cuda_cores
                    if kind == "scan":
                        ssd_scan.SOURCE = variants[n] or source
                        fn = lambda: ssd_scan.ssd_cuda(  # noqa: E731
                            xh, dt, A_log, Bm, Cm, chunk)
                    else:
                        ssd_scan.BWD_SOURCE = variants[n] or bwd_source
                        fn = lambda: ssd_scan.ssd_backward_cuda(  # noqa: E731
                            xh, dt, A_log, Bm, Cm, dy, None, chunk)
                    times[n].append(median_ms(fn, args.reps))
            print(json.dumps({"kind": kind, "case": name,
                              "shape": list(SHAPE), "card": card,
                              "ms": times}), flush=True)
            del xh, dt, A_log, Bm, Cm, dy
            torch.cuda.empty_cache()
    finally:
        ssd_scan.SOURCE, ssd_scan.BWD_SOURCE = source, bwd_source
        ssd_scan.route, ssd_scan.backward_route = route, backward_route
    return 0


if __name__ == "__main__":
    sys.exit(main())
