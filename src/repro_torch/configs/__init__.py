"""Architecture registry: the ten configs of the JAX package (copied as
data) and their reduced smoke-test variants.

``input_specs`` (the dry run's input stand-ins) is not ported yet: it
waits for the ``launch/dryrun`` slice (ROADMAP Queue 1).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Dict

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


__all__ = ["ARCHS", "ARCH_NAMES", "get_config", "reduced_config",
           "InputShape", "ModelConfig", "SHAPES", "applicable_shapes"]
