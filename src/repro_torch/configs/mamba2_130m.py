"""mamba2-130m — attention-free SSM (state-space duality)
[arXiv:2405.21060; unverified].

24L d_model=768, ssm_state=128, expand 2 (d_inner 1536, 24 heads of 64),
vocab=50280, tied embeddings.  Sub-quadratic: runs long_500k."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=1,                  # no attention heads (attn-free)
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    ssm_state_dim=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
    ssm_n_groups=1,
    tie_embeddings=True,
    param_dtype="float32",       # 130M: fp32 params are fine
)
