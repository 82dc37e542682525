"""llava-next-34b — VLM backbone (anyres tiling stubbed)
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.  The vision
tower is a stub per the brief: input_specs provides 2880 precomputed
patch embeddings (anyres 4 tiles + base, 576 each) at the CLIP hidden
width 1024; the multimodal projector is learned."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5e6,
    input_kind="tokens+patches",
    frontend_dim=1024,
    n_patches=2880,
    param_dtype="bfloat16",
)
