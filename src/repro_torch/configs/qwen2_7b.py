"""qwen2-7b — dense with QKV bias [arXiv:2407.10671; hf].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064; rope 1e6."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    rope_theta=1e6,
    qkv_bias=True,
    param_dtype="bfloat16",
)
