#!/usr/bin/env python3
"""Serving times of the PyTorch port from several source trees, on one card.

    python3 tools/serve_ab.py [--arch mamba2-130m|gemma2-9b] ROOT [ROOT ...]

Each ROOT is a checkout of this repository.  For each, in the order
given, a fresh process serves the architecture at chip_smoke.py's serving
shape from ``ROOT/src`` — mamba2-130m (the default): 8 prompts of 4096
tokens; gemma2-9b: 2 prompts of 8192 tokens — at full width with weights
from seed 0 in bf16, then 32 greedy decode steps, and prints one JSON line
with its prefill ms and decode ms per step.  Give the roots in turns
(A B B A ...) so that drift on the host or the card falls on both.  Needs
a CUDA card; each process builds the kernels of its own tree.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

SHAPES = {"mamba2-130m": (8, 4096), "gemma2-9b": (2, 8192)}   # batch, prompt
DECODE = 32


def serve_once(root: str, arch: str) -> dict:
    sys.path.insert(0, f"{root}/src")
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    cfg = get_config(arch)
    batch, prompt = SHAPES[arch]
    params = M.cast_params(M.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda"),
        cfg)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, prompt))).cuda()
    serve.generate(params, cfg, prompts[:, :256], 3)      # build, warm up
    res = serve.generate(params, cfg, prompts, DECODE + 1)
    return {"root": root, "arch": arch, "prefill_ms": res.prefill_s * 1e3,
            "decode_ms_per_step": res.decode_s * 1e3 / res.decode_steps}


def main(argv: list[str]) -> int:
    if argv[:1] == ["--child"]:
        print(json.dumps(serve_once(argv[1], argv[2])), flush=True)
        return 0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=sorted(SHAPES), default="mamba2-130m")
    ap.add_argument("roots", nargs="+")
    args = ap.parse_args(argv)
    for root in args.roots:
        t0 = time.perf_counter()
        subprocess.run([sys.executable, __file__, "--child", root, args.arch],
                       check=True)
        print(f"# {root}: {time.perf_counter() - t0:.1f} s in all", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
