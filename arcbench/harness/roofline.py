"""The yardstick's arithmetic: published peaks of one H100, the least time
of each kernel of the port, and the model FLOPs of a token.

The kernel bounds are copies of ``chip_smoke.py``'s ``bound_ms``,
``ssd_bound_ms``, ``ssd_bwd_bound_ms``, ``flash_bound_ms`` and
``flash_bwd_bound_ms`` (with ``ssd_ops``, ``attended_pairs`` and
``ops_ms``), kept here so that a change to the program does not move
them.  Each returns the least time in ms: inputs read and outputs written
once at the HBM rate, against the operations the function needs at the
peak rate for the dtype, whichever is larger.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12          # CUDA cores
BF16_OPS_PER_S = 989e12         # tensor cores
TF32_OPS_PER_S = 495e12         # tensor cores


def ops_ms(ops: int, dtype: str) -> float:
    """Least time for ``ops`` operations of a kernel's products: bf16 on
    the tensor cores, fp32 as three TF32 products on them."""
    if dtype == "bfloat16":
        return ops / BF16_OPS_PER_S * 1e3
    return 3 * ops / TF32_OPS_PER_S * 1e3


def bound_ms(rows: int, lanes: int) -> float:
    """The integrity hash: each lane read once, each int64 result written
    once, one multiply-add per lane."""
    t_bytes = (rows * lanes * 4 + rows * 8) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * rows * lanes / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops)


def ssd_ops(shape, backward: bool = False) -> int:
    """The least operations of the SSD scan or of its gradient; ``shape``
    is (B, S, H, P, G, N, chunk)."""
    B, S, H, P, G, N, chunk = shape
    Q = min(chunk, S)
    if backward:
        return B * (S // Q) * (H * (Q * (Q + 1) * 2 * P + 10 * Q * N * P)
                               + G * Q * (Q + 1) * 3 * N)
    return B * H * (S // Q) * (Q * (Q + 1) * (N + P) + 4 * Q * N * P)


def ssd_bound_ms(shape, dtype) -> float:
    B, S, H, P, G, N, _ = shape
    el = 2 if dtype == "bfloat16" else 4
    n_bytes = (2 * B * S * H * P * el + B * S * H * 4 + H * 4
               + 2 * B * S * G * N * el + B * H * P * N * 4)
    return max(n_bytes / HBM_BYTES_PER_S * 1e3, ops_ms(ssd_ops(shape), dtype))


def ssd_bwd_bound_ms(shape, dtype) -> float:
    B, S, H, P, G, N, _ = shape
    el = 2 if dtype == "bfloat16" else 4
    n_bytes = (3 * B * S * H * P * el + 4 * B * S * G * N * el
               + 2 * B * S * H * 4 + 2 * H * 4)
    return max(n_bytes / HBM_BYTES_PER_S * 1e3,
               ops_ms(ssd_ops(shape, backward=True), dtype))


def attended_pairs(S: int, causal: bool, window) -> int:
    """(query, key) pairs the mask leaves."""
    s = np.arange(S, dtype=np.int64)
    hi = s if causal else np.full(S, S - 1, dtype=np.int64)
    lo = np.maximum(0, s - window + 1) if window else np.zeros(S, np.int64)
    return int((hi - lo + 1).sum())


def flash_bound_ms(shape, causal, window, dtype, dv=None) -> float:
    """``shape`` is (B, H, KV, S, D)."""
    B, H, KV, S, D = shape
    dv = dv or D
    el = 2 if dtype == "bfloat16" else 4
    n_bytes = (B * H * S * (D + dv) + B * KV * S * (D + dv)) * el
    ops = 2 * B * H * (D + dv) * attended_pairs(S, causal, window)
    return max(n_bytes / HBM_BYTES_PER_S * 1e3, ops_ms(ops, dtype))


def flash_bwd_bound_ms(shape, causal, window, dtype, dv=None) -> float:
    B, H, KV, S, D = shape
    dv = dv or D
    el = 2 if dtype == "bfloat16" else 4
    n_bytes = el * (2 * B * H * S * D + 2 * B * KV * S * (D + dv)
                    + 2 * B * H * S * dv) + 4 * B * H * S
    ops = 2 * B * H * (3 * D + 2 * dv) * attended_pairs(S, causal, window)
    return max(n_bytes / HBM_BYTES_PER_S * 1e3, ops_ms(ops, dtype))


# ---------------------------------------------------------------------- #
# model FLOPs (from the configuration file's sizes; remat not counted)
# ---------------------------------------------------------------------- #

def matmul_params(m: dict) -> int:
    """Parameters that enter a matrix product once per token: every
    layer's projections and the output head (the embedding lookup is no
    product; a tied head is the embedding matrix used once)."""
    D, V, L = m["d_model"], m["vocab_size"], m["n_layers"]
    if m["family"] == "ssm":
        di = m["ssm_expand"] * D
        nh = di // m["ssm_head_dim"]
        GN = m["ssm_n_groups"] * m["ssm_state_dim"]
        layer = D * (2 * di + 2 * GN + nh) + di * D
    else:
        hd = m.get("head_dim") or D // m["n_heads"]
        H, KV = m["n_heads"], m["n_kv_heads"]
        n_in = 2 if m.get("gated_mlp", True) else 1
        layer = D * H * hd + 2 * D * KV * hd + H * hd * D \
            + D * n_in * m["d_ff"] + m["d_ff"] * D
    return L * layer + D * V


def mixing_flops(m: dict, seq: int) -> float:
    """A token's forward FLOPs in the sequence mixer beyond the
    projections: the SSD scan's least operations (``ssd_ops``) and the
    causal conv, or causal attention's two products."""
    D, L = m["d_model"], m["n_layers"]
    if m["family"] == "ssm":
        di = m["ssm_expand"] * D
        H, P = di // m["ssm_head_dim"], m["ssm_head_dim"]
        G, N = m["ssm_n_groups"], m["ssm_state_dim"]
        conv = 2 * m["ssm_conv_width"] * (di + 2 * G * N)
        scan = ssd_ops((1, seq, H, P, G, N, m["ssm_chunk"])) / seq
        return L * (scan + conv)
    hd = m.get("head_dim") or D // m["n_heads"]
    pairs = attended_pairs(seq, True, None) / seq
    return L * 2 * m["n_heads"] * 2 * hd * pairs


def forward_flops_per_token(m: dict, seq: int) -> float:
    return 2 * matmul_params(m) + mixing_flops(m, seq)


def train_flops_per_token(m: dict, seq: int) -> float:
    """Forward and backward (twice the forward) of one token."""
    return 3 * forward_flops_per_token(m, seq)
