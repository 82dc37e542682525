"""Plain PyTorch version of the Mamba2 SSD (state-space duality) scan.

Discrete SSD recurrence per head (state h ∈ R^{P×N}):

    h_t = exp(a_t) · h_{t-1} + (dt_t · x_t) ⊗ B_t        a_t = -exp(A_log)·dt_t
    y_t = C_t · h_t

Chunked evaluation (chunk length Q, cumulative log-decay A_i within a
chunk):

    y_i = Σ_{j≤i} exp(A_i - A_j) (C_i·B_j) (dt_j x_j)     [intra, quadratic]
        + exp(A_i) C_i · h_chunk_start                    [inter, recurrent]

The chunk states are combined by a loop over the chunks in order (the
only serial dependency).  Everything is computed in fp32 (float64 for
float64 inputs, the oracle of the accuracy checks); ``y`` comes back in
``xh``'s dtype and the state as ``[B,H,P,N]`` fp32, as in the JAX
package's ``kernels/ssd_scan/ref.py``.  This is what the CUDA kernels
(``ssd_scan.py``) are held against, and what CPU tensors run, under
autograd on the CPU.

``ssd_backward_reference`` is the scan's gradient in chunked passes (the
chunk-start states, the adjoint passed backwards, the per-chunk products
and d(cum) by fixed-order fp64 sums, as the backward kernels take them):
the CPU tests and ``chip_smoke.py`` hold both backward kernels against it;
no main path runs it.
``ssd_backward_tc_reference`` is the tensor-core backward
(``csrc/ssd_scan_bwd_tc.cu``) in plain PyTorch, rounding where it rounds
(tests only).  ``ssd_split_reference`` and
``ssd_backward_split_reference`` are the fp32 arithmetic of the
``cuda_cores`` route (``csrc/ssd_scan.cu``, ``csrc/ssd_scan_bwd.cu``):
the same passes, each fp32 product as three TF32 products (tests only).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..flash_attention.ref import split_einsum

F32 = torch.float32


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
    f = _compute_dtype(xh)

    dt32 = dt.to(f)
    ac = (-torch.exp(A_log.to(f)) * dt32).reshape(B_, nc, Q, H)
    xdt = (xh.to(f) * dt32[..., None]).reshape(B_, nc, Q, H, P)
    Brep = Bm.to(f).reshape(B_, nc, Q, G, N).repeat_interleave(rep, dim=3)
    Crep = Cm.to(f).reshape(B_, nc, Q, G, N).repeat_interleave(rep, dim=3)

    cum = torch.cumsum(ac, dim=2)                             # A_i (inclusive)
    # intra-chunk: L[i,j] = exp(A_i - A_j) for j <= i.  Above the diagonal
    # the difference is set to 0 before the exp and the result selected
    # away, so no exp there overflows — not in the values and not in the
    # gradient, where an inf times the select's 0 would be NaN
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # [B,nc,i,j,H]
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=xh.device))
    below = tri[None, None, :, :, None]
    L = torch.where(below, torch.exp(torch.where(below, seg, 0.0)), 0.0)
    s = torch.einsum("bcihn,bcjhn->bchij", Crep, Brep)
    w = s * L.permute(0, 1, 4, 2, 3)                          # [B,nc,H,i,j]
    y = torch.einsum("bchij,bcjhp->bcihp", w, xdt)

    # chunk states: Σ_j exp(A_end - A_j) B_j ⊗ xdt_j
    total = cum[:, :, -1, :]                                  # [B,nc,H]
    decay_out = torch.exp(total[:, :, None, :] - cum)         # [B,nc,Q,H]
    states = torch.einsum("bcqhn,bcqhp->bchpn",
                          Brep * decay_out[..., None], xdt)

    # walk the chunks in order; h_prev[c] is the state at chunk c's start
    h = torch.zeros(B_, H, P, N, dtype=f, device=xh.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * torch.exp(total[:, c])[:, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                       # [B,nc,H,P,N]

    # inter-chunk: exp(A_i) C_i · h_start
    y = y + torch.einsum("bcqhn,bchpn->bcqhp",
                         Crep * torch.exp(cum)[..., None], h_prev)
    return y.reshape(B_, S, H, P).to(xh.dtype), h


def ssd_backward_reference(xh: torch.Tensor, dt: torch.Tensor,
                           A_log: torch.Tensor, Bm: torch.Tensor,
                           Cm: torch.Tensor, dy: torch.Tensor,
                           dstate: Optional[torch.Tensor], chunk: int
                           ) -> Tuple[torch.Tensor, ...]:
    """Gradient of ``ssd_reference`` given dy [B,S,H,P] and an optional
    d(final state) [B,H,P,N] -> (dxh, ddt, dA_log, dBm, dCm), dxh, dBm and
    dCm in their inputs' dtypes, ddt and dA_log in fp32 (float64 for
    float64 inputs), in the chunked passes of the backward kernels.

    Per head, with x~_t = dt_t·x_t, h_t the state after token t and the
    adjoint g_t = dL/dh_t = dy_t ⊗ C_t + e^{a_{t+1}} g_{t+1}:
    dC_t = h_tᵀ dy_t, dB_t = g_tᵀ x~_t (each summed over a group's
    heads), dx~_t = g_t B_t, da_t = e^{a_t} <g_t, h_{t-1}>, ddt_t =
    <x_t, dx~_t> - exp(A_log)·da_t, dA_log = Σ a_t·da_t.  Chunked:

    1. chunk-start states h0_c, recomputed (cum of the decays in fp64, as
       the forward sums it);
    2. the adjoint at each chunk's end, G_c, passed backwards over the
       chunks: G_{c-1} = e^{cum_Q} G_c + Σ_i e^{cum_i} dy_i ⊗ C_i, with
       G_last = dstate (or 0);
    3. per chunk, with L_ij = e^{cum_i - cum_j} (j <= i), s_ij = C_i·B_j
       and r_ij = dy_i·x~_j: dx~ = (L∘s)ᵀ dy + e^{cum_Q - cum_j} G B_j,
       dB = (L∘r)ᵀ C + e^{cum_Q - cum_j} Gᵀ x~_j, dC = (L∘r) B +
       e^{cum_i} h0ᵀ dy_i; and d(cum) of the products M = L∘s∘r, taken
       below the diagonal only (the diagonal's two terms cancel), turned
       into da by a reverse cumsum, with the state terms added where no
       cancellation is needed: da_t = Σ_{i>=t} (Σ_{j<i} M_ij - Σ_{k>i}
       M_ki + u_i) + Σ_{j<t} v_j + e^{cum_Q} <G, h0>, u_i = e^{cum_i}
       C_i·(h0ᵀ dy_i), v_j = e^{cum_Q - cum_j} x~_j·(G B_j)."""
    B_, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    nc, rep = S // Q, H // G
    f = _compute_dtype(xh)
    x = xh.to(f).reshape(B_, nc, Q, H, P)
    dtc = dt.to(f).reshape(B_, nc, Q, H)
    A = -torch.exp(A_log.to(f))                               # [H]
    Bq = Bm.to(f).reshape(B_, nc, Q, G, N).repeat_interleave(rep, dim=3)
    Cq = Cm.to(f).reshape(B_, nc, Q, G, N).repeat_interleave(rep, dim=3)
    dyq = dy.to(f).reshape(B_, nc, Q, H, P)
    xdt = x * dtc[..., None]
    cum64 = torch.cumsum(A.double() * dtc.double(), dim=2)    # [B,nc,Q,H]
    total64 = cum64[:, :, -1]                                 # [B,nc,H]
    cum, total = cum64.to(f), total64.to(f)
    w = torch.exp((total64[:, :, None] - cum64).to(f))        # e^{cum_Q-cum_j}
    ecum = torch.exp(cum)

    # 1. chunk-start states
    S_c = torch.einsum("bcqhn,bcqhp->bchpn", Bq * w[..., None], xdt)
    h = torch.zeros(B_, H, P, N, dtype=f, device=xh.device)
    h0 = []
    for c in range(nc):
        h0.append(h)
        h = torch.exp(total[:, c])[:, :, None, None] * h + S_c[:, c]
    h0 = torch.stack(h0, dim=1)                               # [B,nc,H,P,N]

    # 2. adjoint at each chunk's end
    D_c = torch.einsum("bcqhn,bcqhp->bchpn", Cq * ecum[..., None], dyq)
    g = torch.zeros(B_, H, P, N, dtype=f, device=xh.device) \
        if dstate is None else dstate.to(f)
    g_end = [None] * nc
    for c in reversed(range(nc)):
        g_end[c] = g
        g = torch.exp(total[:, c])[:, :, None, None] * g + D_c[:, c]
    g_end = torch.stack(g_end, dim=1)                         # [B,nc,H,P,N]

    # 3. per chunk
    seg = (cum64[:, :, :, None, :] - cum64[:, :, None, :, :]).to(f)
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=xh.device))
    L = torch.where(tri[None, None, :, :, None], torch.exp(seg),
                    0.0).permute(0, 1, 4, 2, 3)               # [B,nc,H,i,j]
    s = torch.einsum("bcihn,bcjhn->bchij", Cq, Bq)
    r = torch.einsum("bcihp,bcjhp->bchij", dyq, xdt)
    Ls, Lr = L * s, L * r
    gB = torch.einsum("bchpn,bcjhn->bcjhp", g_end, Bq)        # G B_j
    hdy = torch.einsum("bchpn,bcihp->bcihn", h0, dyq)         # h0ᵀ dy_i
    dxdt = torch.einsum("bchij,bcihp->bcjhp", Ls, dyq) + w[..., None] * gB
    dBh = torch.einsum("bchij,bcihn->bcjhn", Lr, Cq) + w[..., None] * \
        torch.einsum("bchpn,bcjhp->bcjhn", g_end, xdt)
    dCh = torch.einsum("bchij,bcjhn->bcihn", Lr, Bq) + ecum[..., None] * hdy

    # d(cum): the row and column sums of M, u and v summed in fp64 over
    # products in f, and da's cumsums in fp64, as the kernel takes them
    # (the reverse cumsum of row - column sums cancels every term with
    # j >= t, so their rounding would not cancel)
    strict = torch.tril(tri, diagonal=-1)
    M = torch.where(strict, Ls * r, 0.0).double()
    u = ecum.double() * (Cq * hdy).double().sum(-1)           # [B,nc,Q,H]
    v = w.double() * (xdt * gB).double().sum(-1)
    row = M.sum(-1).permute(0, 1, 3, 2) + u                   # Σ_{j<i} M_ij + u_i
    col = M.sum(-2).permute(0, 1, 3, 2)                       # Σ_{k>j} M_kj
    c0 = torch.exp(total) * (g_end * h0).sum((-1, -2))        # [B,nc,H]
    rev = torch.flip(torch.cumsum(torch.flip(row - col, [2]), dim=2), [2])
    below = torch.cumsum(v, dim=2) - v                        # Σ_{j<t} v_j
    da64 = rev + below + c0.double()[:, :, None]
    da = da64.to(f)

    ddt = (x * dxdt).sum(-1) + A * da
    dA_log = ((A * dtc).double() * da64).sum((0, 1, 2)).to(f)
    dxh = (dxdt * dtc[..., None]).reshape(B_, S, H, P)
    dBm = dBh.reshape(B_, nc, Q, G, rep, N).sum(4).reshape(B_, S, G, N)
    dCm = dCh.reshape(B_, nc, Q, G, rep, N).sum(4).reshape(B_, S, G, N)
    return (dxh.to(xh.dtype), ddt.reshape(B_, S, H), dA_log,
            dBm.to(Bm.dtype), dCm.to(Cm.dtype))



BWD_TC_FAULTS = ("lo dropped", "head summed twice", "adjoint dropped")


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(F32)


def _hi_lo(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    hi = _bf16(t)
    return hi, _bf16(t - hi)


def _head_sum(t: torch.Tensor, G: int, dim: int, twice: bool = False
              ) -> torch.Tensor:
    """The fp32 sum over each group's heads (axis ``dim``) in head order;
    ``twice`` adds each group's first head again (a planted fault)."""
    t = t.unflatten(dim, (G, t.shape[dim] // G))
    acc = t.select(dim + 1, 0)
    if twice:
        acc = acc + t.select(dim + 1, 0)
    for k in range(1, t.shape[dim + 1]):
        acc = acc + t.select(dim + 1, k)
    return acc


def ssd_backward_tc_reference(xh: torch.Tensor, dt: torch.Tensor,
                              A_log: torch.Tensor, Bm: torch.Tensor,
                              Cm: torch.Tensor, dy: torch.Tensor,
                              dstate: Optional[torch.Tensor], chunk: int,
                              fault: Optional[str] = None
                              ) -> Tuple[torch.Tensor, ...]:
    """The tensor-core backward's passes (``csrc/ssd_scan_bwd_tc.cu``) in
    plain PyTorch, rounding where the kernel rounds: what the tests hold
    that design to on the CPU.  It is never on the main path.  The contract
    of ``ssd_backward_reference``; xh, Bm, Cm and dy are taken as bf16
    values (rounded to bf16 first, as the kernel only takes bf16), and the
    outputs come back in the inputs' dtypes (fp32 inputs give the fp32
    values the kernel rounds to bf16 last).

    1. chunk sums: S_c = Σ_j x_j ⊗ bf16(B_j · dt_j · exp(cum_Q - cum_j)),
       D_c = Σ_i dy_i ⊗ bf16(C_i · exp(cum_i)), the fp32 factor rounded
       into the bf16 operand once, sums in fp32; cum in fp64, each
       difference rounded to fp32 once;
    2. state passes in fp32 (one fused multiply-add a step): h0 forward, G
       backward; <G, h0> in fp64; h0 and G rounded once to bf16;
    3. per tile pair, s = C·Bᵀ once per group and r = dt_j (dy_i · x_j) once
       per head; L masked to 0 above the diagonal before the exp; the fp32
       sum over a group's heads, in head order, of W = L∘r; M = (L∘s)∘r
       below the diagonal, its row and column sums in fp64;
    4. dx~ = exp(cum_Q - cum_j)·(G B_j) + hi·dy + lo·dy, hi and lo the bf16
       split of L∘s; <x, dx~> in fp32, v in fp64;
    5. dB = Σ_h dt·exp(cum_Q - cum)·(x G) + hiᵀ C + loᵀ C and dC = Σ_h
       exp(cum)·(dy h0) + hi B + lo B, hi and lo the split of W's sum;
       u = exp(cum) Σ_n C·(dy h0) in fp64;
    6. da, ddt and dA_log as ``ssd_backward_reference`` takes them.

    ``fault`` plants one of ``BWD_TC_FAULTS`` for the tests: the lo
    operands dropped, a group's first head summed twice into W's sum, or
    the adjoint not carried across chunks."""
    if fault is not None and fault not in BWD_TC_FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    B_, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    nc, rep = S // Q, H // G
    x = _bf16(xh).reshape(B_, nc, Q, H, P)
    Bg = _bf16(Bm).reshape(B_, nc, Q, G, N)
    Cg = _bf16(Cm).reshape(B_, nc, Q, G, N)
    Bh, Ch = Bg.repeat_interleave(rep, 3), Cg.repeat_interleave(rep, 3)
    dyq = _bf16(dy).reshape(B_, nc, Q, H, P)
    dtc = dt.to(F32).reshape(B_, nc, Q, H)
    A = -torch.exp(A_log.to(F32))
    cum = torch.cumsum(A.double() * dtc.double(), dim=2)      # [B,nc,Q,H]
    total = cum[:, :, -1:]
    w = torch.exp((total - cum).to(F32))                      # e^{cum_Q-cum_j}
    ecum = torch.exp(cum.to(F32))

    # 1. chunk sums
    S_c = torch.einsum("bcqhn,bcqhp->bchpn",
                       _bf16(Bh * (dtc * w)[..., None]), x)
    D_c = torch.einsum("bcqhn,bcqhp->bchpn", _bf16(Ch * ecum[..., None]), dyq)

    # 2. state passes
    decay = torch.exp(total[:, :, 0].to(F32)).double()[..., None, None]

    def fma(a, s):
        return (decay[:, c] * a.double() + s.double()).to(F32)
    h = torch.zeros(B_, H, P, N, dtype=F32, device=xh.device)
    h0 = []
    for c in range(nc):
        h0.append(h)
        h = fma(h, S_c[:, c])
    h0 = torch.stack(h0, 1)                                   # [B,nc,H,P,N]
    g = torch.zeros_like(h) if dstate is None else dstate.to(F32)
    Ge = [None] * nc
    for c in reversed(range(nc)):
        Ge[c] = g
        g = torch.zeros_like(g) if fault == "adjoint dropped" else \
            fma(g, D_c[:, c])
    Ge = torch.stack(Ge, 1)
    c0 = torch.exp(total[:, :, 0]) * (Ge.double() * h0.double()).sum((-1, -2))
    h0b, Gb = _bf16(h0), _bf16(Ge)

    # 3. pairs
    s = torch.einsum("bcign,bcjgn->bcgij", Cg, Bg)            # [B,nc,G,i,j]
    r = torch.einsum("bcihp,bcjhp->bchij", dyq, x) * \
        dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=xh.device))
    seg = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).to(F32)
    below = tri[None, None, :, :, None]
    L = torch.where(below, torch.exp(torch.where(below, seg, 0.0)),
                    0.0).permute(0, 1, 4, 2, 3)               # [B,nc,H,i,j]
    Ls = L * s.repeat_interleave(rep, 2)
    M = torch.where(torch.tril(tri, -1), Ls * r, 0.0).double()
    row, col = M.sum(-1), M.sum(-2)                           # [B,nc,H,Q]
    W = _head_sum(L * r, G, 2, twice=fault == "head summed twice")

    # 4. columns
    lo = 0.0 if fault == "lo dropped" else 1.0
    hi1, lo1 = _hi_lo(Ls)
    GB = torch.einsum("bchpn,bcjhn->bcjhp", Gb, Bh)           # G B_j
    dxdt = w[..., None] * GB + (
        torch.einsum("bchij,bcihp->bcjhp", hi1, dyq)
        + lo * torch.einsum("bchij,bcihp->bcjhp", lo1, dyq))
    xdx = (x * dxdt).sum(-1)
    v = w.double() * ((x * dtc[..., None]) * GB).double().sum(-1)

    # 5. group
    hi2, lo2 = _hi_lo(W)
    hdy = torch.einsum("bcqhp,bchpn->bcqhn", dyq, h0b)        # h0ᵀ dy
    u = ecum.double() * (Ch * hdy).double().sum(-1)
    dB = _head_sum(torch.einsum("bcqhp,bchpn->bcqhn", x, Gb)
                   * (dtc * w)[..., None], G, 3) + (
        torch.einsum("bcgij,bcign->bcjgn", hi2, Cg)
        + lo * torch.einsum("bcgij,bcign->bcjgn", lo2, Cg))
    dC = _head_sum(hdy * ecum[..., None], G, 3) + (
        torch.einsum("bcgij,bcjgn->bcign", hi2, Bg)
        + lo * torch.einsum("bcgij,bcjgn->bcign", lo2, Bg))

    # 6. finalize
    rows = row.permute(0, 1, 3, 2) + u
    cols = col.permute(0, 1, 3, 2)
    rev = torch.flip(torch.cumsum(torch.flip(rows - cols, [2]), 2), [2])
    da64 = rev + (torch.cumsum(v, 2) - v) + c0[:, :, None]
    ddt = xdx + A * da64.to(F32)
    dA_log = ((A * dtc).double() * da64).sum((0, 1, 2)).to(F32)
    dxh = (dxdt * dtc[..., None]).reshape(B_, S, H, P)
    return (dxh.to(xh.dtype), ddt.reshape(B_, S, H), dA_log,
            dB.reshape(B_, S, G, N).to(Bm.dtype),
            dC.reshape(B_, S, G, N).to(Cm.dtype))

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
       exp), else times exp(cum_i - cum_j) and dt_j, split into bf16 hi =
       bf16(v) and lo = bf16(v - hi); y = exp(cum_i)·(C_i·h_prev) + hi·x +
       lo·x, rounded to xh's dtype.

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
    Pm = torch.where(tri, scores * decay * dt_j, 0.0)
    P_hi = Pm.to(bf).to(F32)
    P_lo = (Pm - P_hi).to(bf).to(F32)
    inter = torch.einsum("bcihn,bchpn->bcihp", Cq, h_prev)
    y = torch.exp(cum.to(F32))[..., None] * inter + \
        (torch.einsum("bchij,bcjhp->bcihp", P_hi, x)
         + torch.einsum("bchij,bcjhp->bcihp", P_lo, x))
    return y.reshape(B_, S, H, P).to(xh.dtype), h



def _split_check(xh, products: int) -> None:
    if xh.dtype != F32:
        raise TypeError(f"the split mirrors fp32 inputs, got {xh.dtype}")
    if products not in (1, 3):
        raise ValueError(f"products must be 1 or 3, got {products}")


def ssd_split_reference(xh: torch.Tensor, dt: torch.Tensor,
                        A_log: torch.Tensor, Bm: torch.Tensor,
                        Cm: torch.Tensor, chunk: int, products: int = 3
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fp32 scan of the ``cuda_cores`` route (``csrc/ssd_scan.cu``) in
    plain PyTorch: its three passes, with each product a·b as the kernel
    takes it on the tensor cores — three TF32 products aₗ·bₕ + aₕ·bₗ +
    aₕ·bₕ, hi = tf32(v) and lo = tf32(v - hi) (``split_einsum``), or the
    one product tf32(a)·tf32(b) with ``products=1`` (what the split is
    there to avoid).  Tests only; never on the main path.

    1. chunk states: cum in fp64, each difference rounded to fp32 once;
       B'_j = B_j · (dt_j · exp(cum_Q - cum_j)) in fp32, S_c = Σ_j x_j ⊗ B'_j;
    2. state passing in fp32: h_prev[c] = h, h <- exp(cum_Q)·h + S_c;
    3. chunk output: scores C_i·B_j, 0 where j > i (the exp not taken),
       else times exp(cum_i - cum_j) and dt_j; y = exp(cum_i)·(C_i·h_prev)
       + scores·x.

    fp32 inputs only."""
    _split_check(xh, products)
    mm = lambda eq, a, b: split_einsum(eq, a, b, products)  # noqa: E731
    B_, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    nc, rep = S // Q, H // G
    x = xh.reshape(B_, nc, Q, H, P)
    Bq = Bm.reshape(B_, nc, Q, G, N).repeat_interleave(rep, 3)
    Cq = Cm.reshape(B_, nc, Q, G, N).repeat_interleave(rep, 3)
    dt32 = dt.to(F32).reshape(B_, nc, Q, H)
    A = -torch.exp(A_log.to(F32))
    cum = torch.cumsum(A.double() * dt32.double(), dim=2)     # [B,nc,Q,H]
    total = cum[:, :, -1:, :]

    # 1. chunk states
    w = dt32 * torch.exp((total - cum).to(F32))
    S_c = mm("bcqhn,bcqhp->bchpn", Bq * w[..., None], x)

    # 2. state passing (one fused multiply-add a step)
    h = torch.zeros(B_, H, P, N, dtype=F32, device=xh.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        decay = torch.exp(total[:, c, 0].to(F32))[:, :, None, None]
        h = (decay.double() * h.double() + S_c[:, c].double()).to(F32)
    h_prev = torch.stack(h_prev, dim=1)                       # [B,nc,H,P,N]

    # 3. chunk output
    scores = mm("bcihn,bcjhn->bchij", Cq, Bq)
    seg = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).to(F32)
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=xh.device))
    below = tri[None, None, :, :, None]
    decay = torch.where(below, torch.exp(torch.where(below, seg, 0.0)),
                        0.0).permute(0, 1, 4, 2, 3)           # [B,nc,H,i,j]
    dt_j = dt32.permute(0, 1, 3, 2)[:, :, :, None, :]
    v = torch.where(tri, scores * decay * dt_j, 0.0)
    y = torch.exp(cum.to(F32))[..., None] * \
        mm("bcihn,bchpn->bcihp", Cq, h_prev) + \
        mm("bchij,bcjhp->bcihp", v, x)
    return y.reshape(B_, S, H, P), h


def ssd_backward_split_reference(xh: torch.Tensor, dt: torch.Tensor,
                                 A_log: torch.Tensor, Bm: torch.Tensor,
                                 Cm: torch.Tensor, dy: torch.Tensor,
                                 dstate: Optional[torch.Tensor], chunk: int,
                                 products: int = 3
                                 ) -> Tuple[torch.Tensor, ...]:
    """The fp32 gradient of the ``cuda_cores`` route
    (``csrc/ssd_scan_bwd.cu``) in plain PyTorch: the passes of
    ``ssd_backward_tc_reference`` with every product as three TF32
    products (``split_einsum``; one with ``products=1``) and nothing
    rounded to bf16 — h0 and G stay fp32.  Tests only.

    1. chunk sums: S_c = Σ_j x_j ⊗ (B_j·dt_j·exp(cum_Q - cum_j)), D_c =
       Σ_i dy_i ⊗ (C_i·exp(cum_i)), cum in fp64;
    2. state passes in fp32: h0 forward, G backward; <G, h0> in fp64;
    3. s = C·Bᵀ once per group, r = dt_j (dy_i·x_j) per head, L masked
       before the exp; W = the heads' fp32 sum of L∘r; M = (L∘s)∘r below
       the diagonal, its row and column sums in fp64;
    4. dx~ = exp(cum_Q - cum_j)·(G B_j) + (L∘s)ᵀ dy; <x, dx~>; v in fp64;
    5. dB = Σ_h dt·exp(cum_Q - cum)·(x G) + Wᵀ C, dC = Σ_h exp(cum)·(dy h0)
       + W B; u in fp64;
    6. da, ddt and dA_log as ``ssd_backward_reference`` takes them.

    fp32 inputs only."""
    _split_check(xh, products)
    mm = lambda eq, a, b: split_einsum(eq, a, b, products)  # noqa: E731
    B_, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    nc, rep = S // Q, H // G
    x = xh.reshape(B_, nc, Q, H, P)
    Bg = Bm.reshape(B_, nc, Q, G, N)
    Cg = Cm.reshape(B_, nc, Q, G, N)
    Bh, Ch = Bg.repeat_interleave(rep, 3), Cg.repeat_interleave(rep, 3)
    dyq = dy.reshape(B_, nc, Q, H, P)
    dtc = dt.to(F32).reshape(B_, nc, Q, H)
    A = -torch.exp(A_log.to(F32))
    cum = torch.cumsum(A.double() * dtc.double(), dim=2)      # [B,nc,Q,H]
    total = cum[:, :, -1:]
    w = torch.exp((total - cum).to(F32))                      # e^{cum_Q-cum_j}
    ecum = torch.exp(cum.to(F32))

    # 1. chunk sums
    S_c = mm("bcqhn,bcqhp->bchpn", Bh * (dtc * w)[..., None], x)
    D_c = mm("bcqhn,bcqhp->bchpn", Ch * ecum[..., None], dyq)

    # 2. state passes
    decay = torch.exp(total[:, :, 0].to(F32)).double()[..., None, None]
    h = torch.zeros(B_, H, P, N, dtype=F32, device=xh.device)
    h0 = []
    for c in range(nc):
        h0.append(h)
        h = (decay[:, c] * h.double() + S_c[:, c].double()).to(F32)
    h0 = torch.stack(h0, 1)                                   # [B,nc,H,P,N]
    g = torch.zeros_like(h) if dstate is None else dstate.to(F32)
    Ge = [None] * nc
    for c in reversed(range(nc)):
        Ge[c] = g
        g = (decay[:, c] * g.double() + D_c[:, c].double()).to(F32)
    Ge = torch.stack(Ge, 1)
    c0 = torch.exp(total[:, :, 0]) * (Ge.double() * h0.double()).sum((-1, -2))

    # 3. pairs
    s = mm("bcign,bcjgn->bcgij", Cg, Bg)                      # [B,nc,G,i,j]
    r = mm("bcihp,bcjhp->bchij", dyq, x) * \
        dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=xh.device))
    seg = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).to(F32)
    below = tri[None, None, :, :, None]
    L = torch.where(below, torch.exp(torch.where(below, seg, 0.0)),
                    0.0).permute(0, 1, 4, 2, 3)               # [B,nc,H,i,j]
    Ls = L * s.repeat_interleave(rep, 2)
    M = torch.where(torch.tril(tri, -1), Ls * r, 0.0).double()
    row, col = M.sum(-1), M.sum(-2)                           # [B,nc,H,Q]
    W = _head_sum(L * r, G, 2)

    # 4. columns
    GB = mm("bchpn,bcjhn->bcjhp", Ge, Bh)                     # G B_j
    dxdt = w[..., None] * GB + mm("bchij,bcihp->bcjhp", Ls, dyq)
    xdx = (x * dxdt).sum(-1)
    v = w.double() * ((x * dtc[..., None]) * GB).double().sum(-1)

    # 5. group
    hdy = mm("bcqhp,bchpn->bcqhn", dyq, h0)                   # h0ᵀ dy
    u = ecum.double() * (Ch * hdy).double().sum(-1)
    dB = _head_sum(mm("bcqhp,bchpn->bcqhn", x, Ge) * (dtc * w)[..., None],
                   G, 3) + mm("bcgij,bcign->bcjgn", W, Cg)
    dC = _head_sum(hdy * ecum[..., None], G, 3) + \
        mm("bcgij,bcjgn->bcign", W, Bg)

    # 6. finalize
    rows = row.permute(0, 1, 3, 2) + u
    cols = col.permute(0, 1, 3, 2)
    rev = torch.flip(torch.cumsum(torch.flip(rows - cols, [2]), 2), [2])
    da64 = rev + (torch.cumsum(v, 2) - v) + c0[:, :, None]
    ddt = xdx + A * da64.to(F32)
    dA_log = ((A * dtc).double() * da64).sum((0, 1, 2)).to(F32)
    dxh = (dxdt * dtc[..., None]).reshape(B_, S, H, P)
    return (dxh, ddt.reshape(B_, S, H), dA_log, dB.reshape(B_, S, G, N),
            dC.reshape(B_, S, G, N))


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
