"""gemma2-9b — dense with local/global alternation + softcaps
[arXiv:2408.00118; hf].

42L d_model=3584 16H (GQA kv=8, head_dim 256) d_ff=14336 vocab=256000;
sliding window 4096 on alternating layers; attn softcap 50, final logit
softcap 30; pre+post RMSNorm; scaled tied embeddings."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    rope_theta=1e4,
    mlp_act="gelu",
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    sliding_window=4096,
    local_global_period=2,
    use_post_norm=True,
    scale_embeddings=True,
    tie_embeddings=True,
    param_dtype="bfloat16",
)
