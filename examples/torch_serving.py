"""Batched serving on the PyTorch port: prefill a batch of prompts and
decode greedily, on any causal arch at its reduced config (the port's
counterpart of examples/serving.py).  The card by default; ``--device
cpu`` runs the plain versions of the kernels.

    PYTHONPATH=src python examples/torch_serving.py --arch deepseek-v3-671b \\
        [--device cpu]

A VLM (llava-next) gets ``min(n_patches, prompt_len - 1)`` patch
embeddings before its tokens.  An encoder (hubert) has no decode; this
example runs its whole-sequence forward over frame embeddings instead.
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, reduced_config
from repro_torch.device import resolve_device
from repro_torch.launch import serve
from repro_torch.models import model as M


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b", choices=ARCH_NAMES)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    args = ap.parse_args()

    cfg = reduced_config(args.arch)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    params = M.cast_params(M.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device),
        cfg)
    B, P, G = args.batch, args.prompt_len, args.gen

    def embeddings(n):
        return torch.from_numpy(rng.normal(size=(B, n, cfg.frontend_dim))
                                .astype(np.float32)).to(device)

    if not cfg.causal:
        out = serve.forward(params, cfg, {"frames": embeddings(P)})
        print(f"[serving] {cfg.name}: encoder, {B} x {P} frames in "
              f"{out.seconds * 1e3:.0f}ms; logits {tuple(out.logits.shape)}")
        return
    patches = None
    if cfg.input_kind == "tokens+patches":
        patches = embeddings(min(cfg.n_patches, P - 1))
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, P - (0 if patches is None
                                    else patches.shape[1])))).to(device)
    out = serve.generate(params, cfg, prompts, G, patches=patches)
    dt = out.prefill_s + out.decode_s
    print(f"[serving] {cfg.name}: {B} seqs, prefill {P} + decode {G - 1} "
          f"in {dt * 1e3:.0f}ms ({B * (G - 1) / max(out.decode_s, 1e-9):.0f} "
          f"tok/s)")
    for b in range(min(B, 2)):
        print(f"  seq{b}: {out.tokens[b, :12].tolist()}")


if __name__ == "__main__":
    main()
