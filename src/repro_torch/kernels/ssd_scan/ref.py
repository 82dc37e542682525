"""Plain PyTorch version of the Mamba2 SSD (state-space duality) scan.

Discrete SSD recurrence per head (state h ∈ R^{P×N}):

    h_t = exp(a_t) · h_{t-1} + (dt_t · x_t) ⊗ B_t        a_t = -exp(A_log)·dt_t
    y_t = C_t · h_t

Chunked evaluation (chunk length Q, cumulative log-decay A_i within a
chunk):

    y_i = Σ_{j≤i} exp(A_i - A_j) (C_i·B_j) (dt_j x_j)     [intra, quadratic]
        + exp(A_i) C_i · h_chunk_start                    [inter, recurrent]

The chunk states are combined by a loop over the chunks in order (the
only serial dependency).  Everything is computed in fp32; ``y`` comes
back in ``xh``'s dtype and the state as ``[B,H,P,N]`` fp32, as in the
JAX package's ``kernels/ssd_scan/ref.py``.  This is what the CUDA kernel
(``ssd_scan.py``) is held against, and what CPU tensors run.
"""

from __future__ import annotations

from typing import Tuple

import torch

F32 = torch.float32


def _decay_logs(dt: torch.Tensor, A_log: torch.Tensor) -> torch.Tensor:
    """a = -exp(A_log)·dt in fp32, [..., H]."""
    return -torch.exp(A_log.to(F32)) * dt.to(F32)


def ssd_reference(xh: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xh [B,S,H,P]; dt [B,S,H] (post-softplus); A_log [H];
    Bm/Cm [B,S,G,N] (G groups shared by H//G heads each).
    Returns (y [B,S,H,P] in xh's dtype, final state [B,H,P,N] fp32)."""
    B_, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    nc = S // Q
    rep = H // G

    dt32 = dt.to(F32)
    ac = _decay_logs(dt32, A_log).reshape(B_, nc, Q, H)
    xdt = (xh.to(F32) * dt32[..., None]).reshape(B_, nc, Q, H, P)
    Brep = Bm.to(F32).reshape(B_, nc, Q, G, N).repeat_interleave(rep, dim=3)
    Crep = Cm.to(F32).reshape(B_, nc, Q, G, N).repeat_interleave(rep, dim=3)

    cum = torch.cumsum(ac, dim=2)                             # A_i (inclusive)
    # intra-chunk: L[i,j] = exp(A_i - A_j) for j <= i, selected (never
    # multiplied) so that an overflowing exp above the diagonal is dropped
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # [B,nc,i,j,H]
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=xh.device))
    L = torch.where(tri[None, None, :, :, None], torch.exp(seg), 0.0)
    s = torch.einsum("bcihn,bcjhn->bchij", Crep, Brep)
    w = s * L.permute(0, 1, 4, 2, 3)                          # [B,nc,H,i,j]
    y = torch.einsum("bchij,bcjhp->bcihp", w, xdt)

    # chunk states: Σ_j exp(A_end - A_j) B_j ⊗ xdt_j
    total = cum[:, :, -1, :]                                  # [B,nc,H]
    decay_out = torch.exp(total[:, :, None, :] - cum)         # [B,nc,Q,H]
    states = torch.einsum("bcqhn,bcqhp->bchpn",
                          Brep * decay_out[..., None], xdt)

    # walk the chunks in order; h_prev[c] is the state at chunk c's start
    h = torch.zeros(B_, H, P, N, dtype=F32, device=xh.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * torch.exp(total[:, c])[:, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                       # [B,nc,H,P,N]

    # inter-chunk: exp(A_i) C_i · h_start
    y = y + torch.einsum("bcqhn,bchpn->bcqhp",
                         Crep * torch.exp(cum)[..., None], h_prev)
    return y.reshape(B_, S, H, P).to(xh.dtype), h


def ssd_three_pass_reference(xh: torch.Tensor, dt: torch.Tensor,
                             A_log: torch.Tensor, Bm: torch.Tensor,
                             Cm: torch.Tensor, chunk: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core kernel's three passes (``csrc/ssd_scan_tc.cu``) in
    plain PyTorch, rounding where the kernel rounds: what the tests hold
    that design to on the CPU.  It is never on the main path.

    1. chunk states: cum in fp64; B'_j = bf16(B_j · (dt_j · exp(cum_Q -
       cum_j))) with the factor in fp32 (the fp64 difference rounded to fp32
       once); S_c = Σ_j x_j ⊗ B'_j from bf16 values, summed in fp32;
    2. state passing: h_prev[c] = bf16(h), h <- exp(cum_Q)·h + S_c in fp32;
    3. chunk output: scores C_i·B_j summed in fp32, 0 where j > i (never the
       exp), else times exp(cum_i - cum_j) and dt_j, rounded to bf16; y =
       exp(cum_i)·(C_i·h_prev) + scores·x, rounded to xh's dtype.

    Inputs are taken as bf16 values (xh, Bm, Cm are rounded to bf16 first,
    as the kernel only takes bf16)."""
    bf = torch.bfloat16
    B_, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    nc, rep = S // Q, H // G
    x = xh.to(bf).to(F32).reshape(B_, nc, Q, H, P)
    Bq = Bm.to(bf).to(F32).reshape(B_, nc, Q, G, N).repeat_interleave(rep, 3)
    Cq = Cm.to(bf).to(F32).reshape(B_, nc, Q, G, N).repeat_interleave(rep, 3)
    dt32 = dt.to(F32).reshape(B_, nc, Q, H)
    A = -torch.exp(A_log.to(F32))
    cum = torch.cumsum(A.double() * dt32.double(), dim=2)     # [B,nc,Q,H]
    total = cum[:, :, -1:, :]

    # 1. chunk states
    w = dt32 * torch.exp((total - cum).to(F32))
    Bs = (Bq * w[..., None]).to(bf).to(F32)
    S_c = torch.einsum("bcqhn,bcqhp->bchpn", Bs, x)

    # 2. state passing
    h = torch.zeros(B_, H, P, N, dtype=F32, device=xh.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h.to(bf).to(F32))
        h = torch.exp(total[:, c, 0].to(F32))[:, :, None, None] * h + S_c[:, c]
    h_prev = torch.stack(h_prev, dim=1)                       # [B,nc,H,P,N]

    # 3. chunk output
    scores = torch.einsum("bcihn,bcjhn->bchij", Cq, Bq)
    seg = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).to(F32)
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=xh.device))
    decay = torch.where(tri[None, None, :, :, None], torch.exp(seg),
                        0.0).permute(0, 1, 4, 2, 3)            # [B,nc,H,i,j]
    dt_j = dt32.permute(0, 1, 3, 2)[:, :, :, None, :]
    Pm = torch.where(tri, scores * decay * dt_j, 0.0).to(bf).to(F32)
    inter = torch.einsum("bcihn,bchpn->bcihp", Cq, h_prev)
    y = torch.exp(cum.to(F32))[..., None] * inter + \
        torch.einsum("bchij,bcjhp->bcihp", Pm, x)
    return y.reshape(B_, S, H, P).to(xh.dtype), h


def chunk_block_rel_err(got: torch.Tensor, want: torch.Tensor,
                        chunk: int) -> float:
    """The per-block check of the bf16 scan: over each (batch, head, chunk)
    block of y [B,S,H,P], max|got - want| / max|want|; the worst block."""
    B_, S, H, P = want.shape
    Q = min(chunk, S)
    g = got.float().reshape(B_, S // Q, Q, H, P)
    w = want.float().reshape(B_, S // Q, Q, H, P)
    num = (g - w).abs().amax(dim=(2, 4))
    den = w.abs().amax(dim=(2, 4)).clamp_min(torch.finfo(F32).tiny)
    return float((num / den).max())


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """fp32, or float64 for float64 inputs (the oracle of the kernels'
    accuracy checks)."""
    return torch.promote_types(x.dtype, F32)


def ssd_decode_reference(xh: torch.Tensor, dt: torch.Tensor,
                         A_log: torch.Tensor, Bm: torch.Tensor,
                         Cm: torch.Tensor, state: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence.  xh [B,1,H,P]; state [B,H,P,N] fp32 (float64
    with float64 inputs)."""
    f = _compute_dtype(xh)
    G = Bm.shape[2]
    rep = xh.shape[2] // G
    dtf = dt[:, 0].to(f)                                      # [B,H]
    decay = torch.exp(-torch.exp(A_log.to(f)) * dtf)[:, :, None, None]
    Br = Bm[:, 0].to(f).repeat_interleave(rep, dim=1)         # [B,H,N]
    Cr = Cm[:, 0].to(f).repeat_interleave(rep, dim=1)
    xdt = xh[:, 0].to(f) * dtf[..., None]                     # [B,H,P]
    new_state = state * decay + torch.einsum("bhp,bhn->bhpn", xdt, Br)
    y = torch.einsum("bhn,bhpn->bhp", Cr, new_state)
    return y[:, None].to(xh.dtype), new_state


def ssd_sequential_oracle(xh, dt, A_log, Bm, Cm
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-by-token recurrence: the ground truth the chunked algorithm
    must match.  Given float64 inputs it computes in float64."""
    B_, S, H, P = xh.shape
    N = Bm.shape[3]
    state = torch.zeros(B_, H, P, N, dtype=_compute_dtype(xh),
                        device=xh.device)
    ys = []
    for t in range(S):
        y, state = ssd_decode_reference(
            xh[:, t:t + 1], dt[:, t:t + 1], A_log,
            Bm[:, t:t + 1], Cm[:, t:t + 1], state)
        ys.append(y)
    return torch.cat(ys, dim=1), state
