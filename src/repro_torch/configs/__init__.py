"""Architecture registry: the ten configs of the JAX package (copied as
data), their reduced smoke-test variants, and ``input_specs``: the
unallocated inputs (``TensorSpec`` trees) of one (arch × shape) cell, which
the dry run and the sharding rules read.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Dict, Optional

import torch

from ..models.config import (InputShape, ModelConfig, SHAPES,
                             applicable_shapes)
from . import (command_r_35b, deepseek_v3_671b, gemma2_9b, hubert_xlarge,
               jamba_1_5_large_398b, llava_next_34b, mamba2_130m,
               moonshot_v1_16b_a3b, qwen2_7b, starcoder2_3b)

_MODULES = [hubert_xlarge, moonshot_v1_16b_a3b, deepseek_v3_671b,
            mamba2_130m, jamba_1_5_large_398b, starcoder2_3b, gemma2_9b,
            command_r_35b, qwen2_7b, llava_next_34b]

ARCHS: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
ARCH_NAMES = list(ARCHS)


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_NAMES}")
    return ARCHS[name]


def reduced_config(name: str) -> ModelConfig:
    """Same family/features, smoke-test scale (CPU-runnable)."""
    cfg = get_config(name)
    kw: Dict[str, Any] = dict(
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads >= 4
        else cfg.n_kv_heads,
        head_dim=32,
        d_ff=0 if cfg.d_ff == 0 else 256,
        vocab_size=512,
        first_dense_layers=min(cfg.first_dense_layers, 1),
        param_dtype="float32",
        compute_dtype="float32",
    )
    kw["n_layers"] = kw["first_dense_layers"] + cfg.block_period
    if cfg.use_mla:
        kw.update(q_lora_rank=64, kv_lora_rank=32, qk_nope_dim=32,
                  qk_rope_dim=16, v_head_dim=32)
    if cfg.n_experts:
        # capacity_factor = E makes dispatch provably dropless, so smoke
        # tests are exactly causal (capacity drops depend on batch length)
        kw.update(n_experts=8,
                  experts_per_token=min(cfg.experts_per_token, 3),
                  moe_d_ff=128, capacity_factor=8.0)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state_dim=32, ssm_head_dim=16, ssm_chunk=32,
                  ssm_n_groups=min(cfg.ssm_n_groups, 2))
    if cfg.sliding_window:
        kw.update(sliding_window=64)
    if cfg.input_kind != "tokens":
        kw.update(frontend_dim=64)
    if cfg.n_patches:
        kw.update(n_patches=16)
    return replace(cfg, **kw)


# ---------------------------------------------------------------------- #
# input specs per (arch × shape)
# ---------------------------------------------------------------------- #

def input_specs(cfg: ModelConfig, shape: InputShape | str,
                per_pod_batch: Optional[int] = None) -> Dict[str, Any]:
    """``TensorSpec`` stand-ins for one (arch × shape) cell.

    Returns {"batch": {...}, "cache": ... | None, "index": ... | None,
    "kind": "train"|"serve"}.  ``per_pod_batch`` overrides the global
    batch (multi-pod runs split the global batch across pods only for
    data; the dry run keeps the global batch and shards it).
    """
    from ..models import model as M
    from ..models.layers import TensorSpec, torch_dtype
    if isinstance(shape, str):
        shape = SHAPES[shape]
    B = per_pod_batch or shape.global_batch
    S = shape.seq_len
    emb_dt = torch_dtype(cfg.compute_dtype)

    def spec(*dims, dtype=torch.int32):
        return TensorSpec(tuple(dims), dtype)

    def token_batch(seq, with_labels):
        b: Dict[str, Any] = {}
        if cfg.input_kind == "frames":
            b["frames"] = spec(B, seq, cfg.frontend_dim, dtype=emb_dt)
        elif cfg.input_kind == "tokens+patches":
            npatch = min(cfg.n_patches, max(seq - 1, 0)) if seq > 1 else 0
            if npatch and seq > npatch:
                b["patches"] = spec(B, npatch, cfg.frontend_dim, dtype=emb_dt)
                b["tokens"] = spec(B, seq - npatch)
            else:
                b["tokens"] = spec(B, seq)
        else:
            b["tokens"] = spec(B, seq)
        if with_labels:
            b["labels"] = spec(B, seq)
        return b

    if shape.kind == "train":
        return {"kind": "train", "batch": token_batch(S, True),
                "cache": None, "index": None}
    if shape.kind == "prefill":
        cache = M.cache_specs(cfg, B, S) if cfg.causal else None
        return {"kind": "serve", "batch": token_batch(S, False),
                "cache": cache,
                "index": spec() if cache is not None else None}
    # decode: one new token against a seq_len-deep cache
    return {"kind": "serve", "batch": {"tokens": spec(B, 1)},
            "cache": M.cache_specs(cfg, B, S), "index": spec()}


__all__ = ["ARCHS", "ARCH_NAMES", "get_config", "reduced_config",
           "input_specs", "InputShape", "ModelConfig", "SHAPES", "applicable_shapes"]
