"""jamba-1.5-large-398b — hybrid Mamba+attention with MoE
[arXiv:2403.19887; hf].

72L d_model=8192 64H (kv=8) d_ff=24576 vocab=65536; 1:7 attn:mamba
interleave (one attention layer per 8), MoE 16 experts top-2 every other
layer.  Block period lcm(8,2)=8 -> 9 scanned blocks.  SSM blocks use the
SSD formulation (hardware-adaptation note in DESIGN.md)."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    rope_theta=1e4,
    attn_layer_period=8,
    n_experts=16,
    experts_per_token=2,
    moe_d_ff=24576,
    moe_layer_period=2,
    ssm_state_dim=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
    ssm_n_groups=8,
    param_dtype="bfloat16",
)
