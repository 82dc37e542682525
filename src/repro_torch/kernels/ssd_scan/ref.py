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
