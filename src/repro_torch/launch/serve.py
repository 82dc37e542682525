"""Serving launcher: batched prefill + greedy decode with the KV / latent
/ SSM state cache, on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \\
      --batch 2 --prompt-len 8192 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v3-671b \\
      --reduced --device cpu --batch 4 --prompt-len 64 --gen 32

Parameters are initialised from ``--seed`` (no weights are downloaded).
Every causal config decodes (``generate``): the dense GQA family, MLA
with MoE (deepseek-v3), MoE (moonshot), the hybrid (jamba) and the VLM
(llava-next, whose prompt is ``min(n_patches, prompt_len - 1)`` patch
embeddings followed by tokens).  An encoder (hubert) has no decode: its
whole-sequence forward over frame embeddings is ``forward``.  With SSM
layers the prompt length must be at most ``ssm_chunk`` or a multiple of
it (the chunked scan's condition).
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..configs import ARCH_NAMES, get_config, reduced_config
from ..device import resolve_device
from ..models import model as M
from ..models.config import ModelConfig
from ..trace import span


def check_servable(cfg: ModelConfig, prompt_len: int) -> None:
    """Raise unless the port can decode ``cfg`` after a prompt of
    ``prompt_len`` positions: any causal config (an encoder has only the
    whole-sequence ``forward``)."""
    if not cfg.causal:
        raise ValueError(f"{cfg.name} is encoder-only: no decode serving")
    q = cfg.ssm_chunk
    has_ssm = any(k.mixer == "ssm" for k in cfg.block_pattern())
    if has_ssm and prompt_len > q and prompt_len % q:
        raise ValueError(f"prompt length {prompt_len} must be <= {q} or a "
                         f"multiple of it (ssm_chunk)")


@dataclass
class Generation:
    tokens: torch.Tensor                  # [B, gen] greedy continuation
    prefill_logits: torch.Tensor          # [B, P, V]
    prefill_s: float                      # prefill wall time, synchronised
    decode_s: float                       # all decode steps, synchronised
    decode_steps: int


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        with span("serve.sync"):
            torch.cuda.synchronize(device)


def generate(params, cfg: ModelConfig, prompts: torch.Tensor, gen: int,
             patches: Optional[torch.Tensor] = None) -> Generation:
    """Prefill ``prompts`` [B, P] (one SSD scan or flash attention launch
    per layer on the card), then ``gen - 1`` greedy decode steps: ``gen``
    new tokens in all.  A VLM's ``patches`` [B, Np, frontend_dim] come
    before the tokens: the prompt is Np + P positions."""
    B, P = prompts.shape
    batch: Dict[str, torch.Tensor] = {"tokens": prompts}
    if patches is not None:
        batch = {"patches": patches, "tokens": prompts}
        P += patches.shape[1]
    check_servable(cfg, P)
    device = prompts.device
    cache = M.init_cache(cfg, B, P + gen, device=device)
    _sync(device)
    t0 = time.perf_counter()
    with span("serve.prefill"):
        logits, cache = M.serve_step(params, cfg, batch, cache, 0)
        tok = logits[:, -1:].argmax(-1)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    with span("serve.decode"):
        for j in range(gen - 1):
            step_logits, cache = M.serve_step(params, cfg, {"tokens": tok},
                                              cache, P + j)
            tok = step_logits[:, -1:].argmax(-1)
            out.append(tok)
    _sync(device)
    return Generation(torch.cat(out, dim=1), logits, t_prefill,
                      time.perf_counter() - t0, gen - 1)


@dataclass
class Forward:
    logits: torch.Tensor                  # [B, S, V]
    seconds: float                        # wall time, synchronised


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Forward:
    """One whole-sequence forward with no cache (``serve_step(params, cfg,
    batch, None, None)``): an encoder's serving step (hubert over its
    frame embeddings), and the reference a decode is held against."""
    device = next(iter(batch.values())).device
    _sync(device)
    t0 = time.perf_counter()
    logits, _ = M.serve_step(params, cfg, batch, None, None)
    _sync(device)
    return Forward(logits, time.perf_counter() - t0)


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else \
        get_config(args.arch)
    B, P = args.batch, args.prompt_len
    if cfg.causal:
        check_servable(cfg, P)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = M.cast_params(M.init_params(cfg, gen, device=device), cfg)
    rng = np.random.default_rng(args.seed)

    def embeddings(n):
        return torch.from_numpy(rng.normal(size=(B, n, cfg.frontend_dim))
                                .astype(np.float32)).to(device)

    if not cfg.causal:                    # encoder: frames, one forward
        fwd = forward(params, cfg, {"frames": embeddings(P)})
        print(f"[serve] {cfg.name} on {device}: forward {B}x{P} frames in "
              f"{fwd.seconds * 1e3:.1f}ms; logits "
              f"{tuple(fwd.logits.shape)}")
        return
    patches = None
    if cfg.input_kind == "tokens+patches":
        patches = embeddings(min(cfg.n_patches, P - 1))
        P -= patches.shape[1]
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, P))).to(device)
    out = generate(params, cfg, prompts, args.gen, patches=patches)
    print(f"[serve] {cfg.name} on {device}: prefill {B}x{args.prompt_len} in "
          f"{out.prefill_s * 1e3:.1f}ms; decoded {out.decode_steps} steps in "
          f"{out.decode_s * 1e3:.1f}ms "
          f"({B * out.decode_steps / max(out.decode_s, 1e-9):.1f} tok/s)")
    print(f"[serve] sample continuation: {out.tokens[0, :16].tolist()}")


if __name__ == "__main__":
    main()
