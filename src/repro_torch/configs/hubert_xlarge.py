"""hubert-xlarge — audio encoder [arXiv:2106.07447; unverified].

48L d_model=1280 16H (kv=16, i.e. MHA) d_ff=5120 vocab=504.
Encoder-only (bidirectional, no decode shapes); the conv waveform
frontend is a stub: input_specs provides precomputed frame embeddings
(dim 512, the conv stack's output width).  FFN is the classic 2-matrix
GELU block."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    gated_mlp=False,
    mlp_act="gelu",
    qkv_bias=True,
    mlp_bias=True,
    input_kind="frames",
    frontend_dim=512,
    param_dtype="bfloat16",
)
