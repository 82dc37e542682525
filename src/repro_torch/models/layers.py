"""Neural layers of the port, in PyTorch: the numerics helpers and the
Mamba2 (SSD) mixer of the JAX package's ``models/layers.py``.

The mixer's chunked scan goes through ``kernels/ssd_scan/ops.ssd``: the
hand-written CUDA kernel for CUDA tensors, the plain version for CPU
tensors.  The parameter shapes of the attention, MLA, MLP and MoE layers
are here too (pure data, so that ``param_specs`` and ``param_count``
cover every config); their forward passes are not ported yet (ROADMAP
Queue 1, "attention/MLA/MLP/MoE layers").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan import ops as ssd_ops
from .config import ModelConfig

NOT_PORTED = ("not ported yet: ROADMAP.md Queue 1, the attention/MLA/MLP/MoE "
              "layers")


@dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a tensor not yet allocated (the port's
    ``jax.ShapeDtypeStruct``; a leaf of a tree)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def torch_dtype(name) -> torch.dtype:
    """"float32" / "bfloat16" / a torch dtype -> the torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# ---------------------------------------------------------------------- #
# numerics helpers
# ---------------------------------------------------------------------- #

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm in fp32 with a ``1 + w`` gain (zero-initialised w), cast
    back to x's dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x), as ``jax.nn.softplus`` computes it (no threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------- #
# parameter shapes of the layers whose forward is not ported yet
# ---------------------------------------------------------------------- #

def gqa_params_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    shapes = {
        "wq": (D, KV, H // KV, hd),
        "wk": (D, KV, hd),
        "wv": (D, KV, hd),
        "wo": (KV, H // KV, hd, D),
    }
    if cfg.qkv_bias:
        shapes.update({"bq": (KV, H // KV, hd), "bk": (KV, hd),
                       "bv": (KV, hd)})
    return shapes


def mla_params_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    D, H = cfg.d_model, cfg.n_heads
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq_a": (D, qr), "q_norm": (qr,),
        "wq_b": (qr, H, dn + dr),
        "wkv_a": (D, kr + dr), "kv_norm": (kr,),
        "wkv_b": (kr, H, dn + dv),
        "wo_mla": (H, dv, D),
    }


def mlp_params_shapes(cfg: ModelConfig, d_ff: int) -> Dict[str, Tuple]:
    D = cfg.d_model
    n_in = 2 if cfg.gated_mlp else 1
    shapes = {"wi": (D, n_in, d_ff), "wo": (d_ff, D)}
    if cfg.mlp_bias:
        shapes.update({"bi": (n_in, d_ff), "bo": (D,)})
    return shapes


def moe_params_shapes(cfg: ModelConfig) -> Dict[str, Tuple]:
    D, E, F_ = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    shapes = {
        "router": (D, E),
        "experts": {"wi": (E, D, 2, F_), "wo": (E, F_, D)},
    }
    if cfg.n_shared_experts:
        shapes["shared"] = mlp_params_shapes(
            cfg, cfg.moe_d_ff * cfg.n_shared_experts)
    return shapes


# ---------------------------------------------------------------------- #
# Mamba2 (SSD) mixer
# ---------------------------------------------------------------------- #

def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_head_dim, cfg.ssm_state_dim


def ssm_params_shapes(cfg: ModelConfig) -> Dict[str, Tuple]:
    D = cfg.d_model
    di, nh, hd, ds = ssm_dims(cfg)
    G = cfg.ssm_n_groups
    conv_ch = di + 2 * G * ds
    return {
        "in_proj": (D, 2 * di + 2 * G * ds + nh),   # z, x, B, C, dt
        "conv_w": (cfg.ssm_conv_width, conv_ch),
        "conv_b": (conv_ch,),
        "A_log": (nh,),
        "D_skip": (nh,),
        "dt_bias": (nh,),
        "out_norm": (di,),
        "out_proj": (di, D),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d.  x [B,S,C]; w [W,C].  With ``state``
    ([B,W-1,C]) runs incrementally and returns the new state.  The taps
    are summed elementwise in x's dtype (no convolution library call, so
    no TF32 on the card)."""
    W = w.shape[0]
    S = x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, W - 1, 0))
        new_state = xp[:, -(W - 1):, :] if W > 1 else None
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
        new_state = xp[:, -(W - 1):, :]
    out = sum(xp[:, i:i + S, :] * w[i] for i in range(W))
    return F.silu((out + b).float()).to(x.dtype), new_state


def ssm_mixer(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ModelConfig,
              cache: Optional[Dict[str, torch.Tensor]] = None):
    """Mamba2 block mixer.  cache = {"conv" [B,W-1,C], "state" [B,H,P,N]}.
    Returns (out [B,S,D], new cache or None)."""
    B, S, D = x.shape
    di, nh, hd, ds = ssm_dims(cfg)
    G = cfg.ssm_n_groups
    zxbcdt = torch.matmul(x, p["in_proj"])
    z, xi, Bm, Cm, dt = torch.split(zxbcdt, [di, di, G * ds, G * ds, nh],
                                    dim=-1)
    conv_in = torch.cat([xi, Bm, Cm], dim=-1)
    conv_out, new_conv = _causal_conv(
        conv_in, p["conv_w"], p["conv_b"],
        state=None if cache is None else cache["conv"])
    xi, Bm, Cm = torch.split(conv_out, [di, G * ds, G * ds], dim=-1)
    xh = xi.reshape(B, S, nh, hd)
    Bm = Bm.reshape(B, S, G, ds)
    Cm = Cm.reshape(B, S, G, ds)
    dt = softplus(dt.float() + p["dt_bias"])
    if cache is None or S > 1:
        # training or prefill: chunked SSD; final state seeds decoding
        y, final = ssd_ops.ssd(xh, dt, p["A_log"], Bm, Cm,
                               chunk=min(cfg.ssm_chunk, S))
        new_cache = None if cache is None else \
            {"conv": new_conv, "state": final}
    else:
        y, new_state = ssd_ops.ssd_decode(xh, dt, p["A_log"], Bm, Cm,
                                          cache["state"])
        new_cache = {"conv": new_conv, "state": new_state}
    y = y + xh * p["D_skip"].to(y.dtype)[None, None, :, None]
    y = y.reshape(B, S, di)
    y = rms_norm(y, p["out_norm"], cfg.norm_eps)
    y = y * F.silu(z.float()).to(y.dtype)
    return torch.matmul(y, p["out_proj"]), new_cache


def ssm_cache_spec(cfg: ModelConfig, batch: int) -> Dict[str, TensorSpec]:
    di, nh, hd, ds = ssm_dims(cfg)
    G = cfg.ssm_n_groups
    conv_ch = di + 2 * G * ds
    return {
        "conv": TensorSpec((batch, cfg.ssm_conv_width - 1, conv_ch),
                           torch_dtype(cfg.compute_dtype)),
        "state": TensorSpec((batch, nh, hd, ds), torch.float32),
    }
