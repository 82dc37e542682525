"""deepseek-v3-671b — MoE with MLA + MTP [arXiv:2412.19437; hf].

61L d_model=7168 128H vocab=129280; MLA (q_lora 1536, kv_lora 512,
qk_nope 128, qk_rope 64, v 128); 1 shared + 256 routed experts top-8
with expert d_ff=2048; first 3 layers dense (d_ff 18432); MTP depth 1."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,                   # dense prologue layers
    vocab_size=129280,
    rope_theta=1e4,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=256,
    n_shared_experts=1,
    experts_per_token=8,
    moe_d_ff=2048,
    moe_layer_period=1,
    first_dense_layers=3,
    mtp_depth=1,
    param_dtype="bfloat16",
)
