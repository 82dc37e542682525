"""moonshot-v1-16b-a3b — MoE (kimi/moonlight)
[hf:moonshotai/Moonlight-16B-A3B; hf].

48L d_model=2048 16H (kv=16) vocab=163840, MoE 64 experts top-6 with
expert d_ff=1408 (per the assigned spec)."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,                 # unused on MoE layers; kept for spec parity
    vocab_size=163840,
    rope_theta=5e4,
    n_experts=64,
    experts_per_token=6,
    moe_d_ff=1408,
    moe_layer_period=1,
    param_dtype="bfloat16",
)
