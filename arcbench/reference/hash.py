"""The lane-polynomial integrity hash, plainly:

    h(x) = Σ_i x_i · r^i  (mod 2^32),   r = 2654435761,

over the little-endian uint32 lanes of a tensor's bytes, zero-padded to a
whole lane.  Lanes are taken in pieces; a piece starting at lane o adds
r^o · Σ_j x_{o+j} r^j.  Products of two values below 2^32 are split into
16-bit halves so that nothing passes int64's range.
"""

from __future__ import annotations

import torch

R = 2654435761
MASK = 0xFFFFFFFF
PIECE = 1 << 22


def _mulmod(a: torch.Tensor, b) -> torch.Tensor:
    lo = a * (b & 0xFFFF)
    hi = (a * (b >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & MASK


def _powers(n: int, device) -> torch.Tensor:
    """[r^0, ..., r^(n-1)] mod 2^32 by repeated squaring of a doubling
    table (int64 on ``device``)."""
    out = torch.ones(1, dtype=torch.int64, device=device)
    step = R
    while out.numel() < n:
        out = torch.cat([out, _mulmod(out, torch.tensor(
            step, dtype=torch.int64, device=device))])
        step = (step * step) & MASK
    return out[:n]


def lanes(x: torch.Tensor) -> torch.Tensor:
    """The tensor's bytes as int64 lane values in [0, 2^32)."""
    raw = x.detach().contiguous().reshape(-1).view(torch.uint8)
    pad = (-raw.numel()) % 4
    if pad:
        raw = torch.cat([raw, raw.new_zeros(pad)])
    return raw.view(torch.int32).to(torch.int64) & MASK


def tensor_hash(x: torch.Tensor) -> int:
    v = lanes(x)
    n = v.numel()
    w = _powers(min(n, PIECE), v.device)
    total = 0
    step = pow(R, PIECE, 1 << 32)
    scale = 1
    for o in range(0, n, PIECE):
        part = v[o:o + PIECE]
        s = int(_mulmod(part, w[:part.numel()]).sum()) & MASK
        total = (total + s * scale) & MASK
        scale = (scale * step) & MASK
    return total


def tree_hashes(named) -> list:
    """One hash per (name, tensor), in the order given."""
    return [tensor_hash(t) for _, t in named]
