"""Model configuration schema covering all ten assigned architectures
(the JAX package's ``models/config.py``, with the parameter walk on the
port's own ``param_specs``).

One ``ModelConfig`` describes dense / MoE / SSM / hybrid / encoder / VLM
families.  Layer heterogeneity (jamba's 1:7 attn:mamba interleave,
gemma2's local/global alternation, MoE every-k-layers) is expressed as a
repeating *block pattern*: the model scans over identical blocks of
``block_period`` layers, which keeps the lowered HLO small enough to
compile 61-layer 671B-parameter graphs for 512 devices.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class LayerKind:
    mixer: str          # "attn" | "ssm"
    moe: bool = False
    local: bool = False  # sliding-window attention layer (gemma2)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 => d_model // n_heads

    # attention flavour
    causal: bool = True          # False => encoder (hubert)
    rope_theta: float = 1e4
    qkv_bias: bool = False
    mlp_bias: bool = False
    gated_mlp: bool = True       # False => 2-matrix FFN (starcoder2/hubert)
    mlp_act: str = "silu"        # silu | gelu
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None   # window for "local" layers
    local_global_period: int = 0 # gemma2: 2 => alternate local/global
    parallel_block: bool = False # command-r: attn & ffn in parallel
    use_post_norm: bool = False  # gemma2: post-sublayer RMSNorm
    scale_embeddings: bool = False  # gemma2: embed * sqrt(d_model)
    tie_embeddings: bool = False

    # MLA (deepseek-v3)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mla_absorb: bool = True      # absorbed decode (attend in latent space)

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    moe_layer_period: int = 1    # MoE every k-th layer within a block
    first_dense_layers: int = 0  # leading dense layers (deepseek: 3)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001

    # SSM (mamba2 / jamba)
    attn_layer_period: int = 0   # hybrid: 1 attn per this many layers
    ssm_state_dim: int = 128
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    ssm_n_groups: int = 1

    # multi-token prediction (deepseek-v3)
    mtp_depth: int = 0

    # modality frontend stub
    input_kind: str = "tokens"   # tokens | frames | tokens+patches
    frontend_dim: int = 0        # stub embedding dim (frames/patches)
    n_patches: int = 0           # VLM: patches per sequence

    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    remat: str = "block"         # none | block (checkpoint each block)
    scan_unroll: bool = False    # unroll the block scan (accurate HLO
                                 # FLOP counts for roofline; bigger HLO)

    # ------------------------------------------------------------------ #
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def block_period(self) -> int:
        """Layers per scanned block (the repeating pattern length)."""
        p = 1
        if self.attn_layer_period:
            p = self.attn_layer_period
        if self.local_global_period:
            p = _lcm(p, self.local_global_period)
        if self.n_experts and self.moe_layer_period > 1:
            p = _lcm(p, self.moe_layer_period)
        return p

    @property
    def n_blocks(self) -> int:
        body = self.n_layers - self.first_dense_layers
        if body % self.block_period:
            raise ValueError(
                f"{self.name}: {body} body layers not divisible by block "
                f"period {self.block_period}")
        return body // self.block_period

    def block_pattern(self) -> List[LayerKind]:
        """Layer kinds inside one block (identical across blocks)."""
        kinds = []
        for i in range(self.block_period):
            if self.attn_layer_period:
                mixer = "attn" if i == 0 else "ssm"
            elif self.family == "ssm":
                mixer = "ssm"
            else:
                mixer = "attn"
            local = bool(self.local_global_period) and \
                (i % self.local_global_period == 0)
            moe = bool(self.n_experts) and \
                (i % self.moe_layer_period == (self.moe_layer_period - 1)
                 if self.moe_layer_period > 1 else True)
            kinds.append(LayerKind(mixer=mixer, moe=moe, local=local))
        return kinds

    # ---------------------- analytics (roofline) ----------------------- #
    def param_count(self) -> int:
        return sum(_numel(s) for s in _iter_param_shapes(self))

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed-active experts)."""
        total = 0
        for spec_name, shape in _iter_param_shapes(self, named=True):
            n = _numel(shape)
            if "['experts']" in spec_name:
                n = n * self.experts_per_token // self.n_experts
            total += n
        return total

    def model_flops_per_token(self) -> int:
        """6·N_active (the §Roofline MODEL_FLOPS convention)."""
        return 6 * self.active_param_count()


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def _numel(shape: Tuple[int, ...]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _iter_param_shapes(cfg: ModelConfig, named: bool = False):
    """Enumerate parameter shapes without building arrays (used by the
    analytic param counts; must agree with model.param_specs)."""
    from . import model  # late import to avoid cycle
    from ..tree import leaf_paths
    for name, leaf in leaf_paths(model.param_specs(cfg)):
        yield (name, tuple(leaf.shape)) if named else tuple(leaf.shape)


# ---------------------------------------------------------------------- #
# input shapes (the assigned shape set)
# ---------------------------------------------------------------------- #
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> List[str]:
    """Shape applicability rules (recorded in DESIGN.md §4)."""
    out = ["train_4k", "prefill_32k"]
    if cfg.causal:                       # encoder-only: no decode
        out.append("decode_32k")
        if cfg.family in ("ssm", "hybrid"):   # sub-quadratic state archs
            out.append("long_500k")
    return out
