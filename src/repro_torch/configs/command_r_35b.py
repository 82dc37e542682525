"""command-r-35b — dense, parallel attention+FFN block, no biases
[hf:CohereForAI/c4ai-command-r-v01; unverified].

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000; rope theta 8e6;
tied embeddings; parallel residual block."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    rope_theta=8e6,
    parallel_block=True,
    tie_embeddings=True,
    param_dtype="bfloat16",
)
