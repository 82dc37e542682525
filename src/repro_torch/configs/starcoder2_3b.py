"""starcoder2-3b — dense code LM [arXiv:2402.19173; hf].

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152; RoPE, biased
projections, 2-matrix GELU FFN."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    rope_theta=1e5,
    qkv_bias=True,
    mlp_bias=True,
    gated_mlp=False,
    mlp_act="gelu",
    param_dtype="bfloat16",
)
