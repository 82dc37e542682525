#!/usr/bin/env python3
"""Serving times of the PyTorch port from several source trees, on one card.

    python3 tools/serve_ab.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository.  For each, in the order
given, a fresh process serves mamba2-130m at chip_smoke.py's serving
shape (full width, weights from seed 0, bf16, 8 prompts of 4096 tokens,
32 greedy decode steps) from ``ROOT/src`` and prints one JSON line with
its prefill ms and decode ms per step.  Give the roots in turns (A B B A
...) so that drift on the host or the card falls on both.  Needs a CUDA
card; each process builds the kernels of its own tree.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def serve_once(root: str) -> dict:
    sys.path.insert(0, f"{root}/src")
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    cfg = get_config("mamba2-130m")
    params = M.cast_params(M.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda"),
        cfg)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 4096))).cuda()
    serve.generate(params, cfg, prompts[:, :256], 3)      # build, warm up
    res = serve.generate(params, cfg, prompts, 33)
    return {"root": root, "prefill_ms": res.prefill_s * 1e3,
            "decode_ms_per_step": res.decode_s * 1e3 / res.decode_steps}


def main(argv: list[str]) -> int:
    if argv[:1] == ["--child"]:
        print(json.dumps(serve_once(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv:
        t0 = time.perf_counter()
        subprocess.run([sys.executable, __file__, "--child", root], check=True)
        print(f"# {root}: {time.perf_counter() - t0:.1f} s in all", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
