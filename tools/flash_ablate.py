#!/usr/bin/env python3
"""Where the bf16 flash-attention kernel's time goes, on one card.

    python3 tools/flash_ablate.py [--only base,nosoftmax,...] [--reps N]

Builds variants of ``src/repro_torch/csrc/flash_attention.cu``, each the
source with one text substitution, and times them in turns at the bf16
serving shapes (the layer's [B,S,H,D] views, 2 x 8192 tokens):

  base        the source as it is
  nosoftmax   no online softmax: raw scores go to P·V (output wrong)
  noqk        no Q·Kᵀ products after the first tile (output wrong)
  nopv        no P·V products but the last (output wrong)
  nocopy      no K/V copies: the producer only arrives on the full
              barriers, so the tiles are stale (output wrong)
  fasttanh    the softcap's tanh as 1 - 2/(2^(2x·log2 e) + 1) from
              ex2.approx and rcp.approx instead of tanhf
  approxtanh  the softcap's tanh as tanh.approx.f32
  bc64        64-key tiles at every head dim

Each variant is compiled with the kernels' own nvcc flags into
``src/repro_torch/_build/ablate_<name>.so`` (all in parallel), loaded in
place of the kernel's library, and timed at each shape in two rounds of
opposite order (median of --reps launches each, L2 flushed, CUDA events),
with its output's row error against the plain version (max over rows of
max|kernel - plain| / max|plain|) and the local (spill) bytes of its
kernels.  Prints the card's ``name, power.limit`` line, then one JSON line
per variant's attributes and per shape.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

TANH = '''__device__ __forceinline__ float tanh_fast(float x) {
  const float e = fast_exp2(x * 2.8853900817779268f);
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(e + 1.f));
  return fmaf(-2.f, r, 1.f);
}
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// What a consumer thread needs'''
SOFTMAX_CALLS = (
    "        online_softmax<Bc, kCap, true>(sc, m, l, alpha, ctx, k0);\n"
    "      else\n"
    "        online_softmax<Bc, kCap, false>(sc, m, l, alpha, ctx, k0);")
COPY = ("        mbar_expect_tx({x}_full + st, C::kTileBytes);\n"
        "#pragma unroll\n"
        "        for (int c = 0; c < C::kBoxes; ++c)\n"
        "          tma_load({x}d + c * Bc * 128, &a.{x}map, {x}_full + st, "
        "64 * c, k0, kvh, b);")
VARIANTS = {
    "base": [],
    "nosoftmax": [(SOFTMAX_CALLS, "        alpha[0] = alpha[1] = 1.f;\n"
                                  "      else\n"
                                  "        alpha[0] = alpha[1] = 1.f;")],
    "noqk": [("      issue_qk(sc, i);\n      wgmma_commit();\n      issue_pv",
              "      wgmma_commit();\n      issue_pv")],
    "nopv": [("      issue_pv(o, pa, i - 1);\n", "")],
    "nocopy": [(COPY.format(x="k"), "        mbar_arrive(k_full + st);"),
               (COPY.format(x="v"),
                "        mbar_arrive(v_full + st); (void)kd; (void)vd;"
                " (void)k0;")],
    "fasttanh": [("// What a consumer thread needs", TANH),
                 ("tanhf(x * c.pre)", "tanh_fast(x * c.pre)")],
    "approxtanh": [("// What a consumer thread needs", TANH),
                   ("tanhf(x * c.pre)", "tanh_approx(x * c.pre)")],
    "bc64": [("static constexpr int kBc = D == 256 ? 64 : 128;",
              "static constexpr int kBc = 64;")],
}
G2 = (2, 16, 8, 8192, 256)
SHAPES = [("qwen2 width", (2, 28, 4, 8192, 128), dict(causal=True), 1.0),
          ("gemma2 global", G2, dict(causal=True, cap=50.0), 1.0),
          ("gemma2 local", G2, dict(causal=True, window=4096, cap=50.0), 1.0),
          ("gemma2 global q x16", G2, dict(causal=True, cap=50.0), 16.0)]


def variant_source(base: str, name: str) -> str:
    src = base
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"variant {name}: the source no longer holds "
                               f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(name: str, base: str) -> Path:
    from repro_torch.kernels import nvcc

    nvcc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = nvcc.BUILD_DIR / f"ablate_{name}.cu"
    cu.write_text(variant_source(base, name))
    so = nvcc.BUILD_DIR / f"ablate_{name}.so"
    res = subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS, "-o", str(so),
                          str(cu)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{res.stderr}")
    return so


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(VARIANTS))
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    names = args.only.split(",")
    import numpy as np
    import torch

    from repro_torch.kernels import nvcc
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops, ref

    if not torch.cuda.is_available():
        print("flash_ablate: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    base = fa.SOURCE.read_text()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(lambda n: build(n, base), names)))
    print(f"# {len(names)} variants built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    libs = {}
    for name, so in built.items():
        libs[name] = ctypes.CDLL(str(so))
        fa._bind(libs[name])
        nvcc._libs[fa.SOURCE] = libs[name]
        local = {f"D{d}{' cap' if c else ''}":
                 fa.kernel_info(torch.bfloat16, d, c)["local_bytes"]
                 for d in (128, 256) for c in (False, True)}
        print(json.dumps(dict(variant=name, local_bytes=local)), flush=True)

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def timed(fn) -> float:
        fn()
        times = []
        for _ in range(args.reps):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    for shape_name, (B, H, KV, S, D), kw, q_mul in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn((B, S, n, D), device="cuda", generator=gen)
                   for n in (H, KV, KV))
        q, k, v = ((t * m).to(torch.bfloat16).transpose(1, 2)
                   for t, m in ((q, q_mul), (k, 1.0), (v, 1.0)))
        want = ref.attention_reference(q, k, v, **kw).float()
        ms, row_err = {}, {}
        for order in (names, names[::-1]):
            for name in order:
                nvcc._libs[fa.SOURCE] = libs[name]
                ms.setdefault(name, []).append(
                    timed(lambda: ops.flash_attention(q, k, v, **kw)))
                if name not in row_err:
                    got = ops.flash_attention(q, k, v, **kw).float()
                    row_err[name] = float(
                        ((got - want).abs().amax(-1)
                         / want.abs().amax(-1).clamp_min(1e-30)).max())
                    del got
        print(json.dumps(dict(shape=shape_name, options=kw, q_mul=q_mul,
                              ms=ms, row_err=row_err)), flush=True)
        del q, k, v, want
        torch.cuda.empty_cache()
    nvcc._libs.pop(fa.SOURCE, None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
