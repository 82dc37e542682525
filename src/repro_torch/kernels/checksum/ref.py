"""Plain PyTorch version of the lane-parallel polynomial integrity hash.

    h(x) = Σ_i  x_i · r^i   (mod 2^32),   r = 2654435761 (odd)

over the little-endian uint32 lanes of a tensor's bytes, zero-padded to
a whole lane.  r is odd, so every weight r^i is odd and any change to a
single lane (a torn 8-byte unit, a bit flip) changes h; multi-lane
corruptions collide with probability ~2^-32.  Like CRC32 it is not
cryptographic.

The hash is blockwise combinable: for blocks of length L,
    h(x) = Σ_b  h(block_b) · r^(bL)
which is how this version evaluates long rows (a 16 KiB weight vector
reused across blocks, one factor per block) and why the CUDA kernel in
``checksum.py`` may sum its per-block partials in any order.

Integer hazards.  Lanes are held as int64 values in [0, 2^32).  The
product of two such values can reach 2^64, past int64's range, so every
product goes through ``_mulmod``: one factor is split into 16-bit
halves, keeping each partial product below 2^48, and every product and
sum is masked back to 32 bits.  ``torch.sum`` of int64 stays int64, and
a sum of at most ``_BLOCK`` masked products stays below 2^44.

These functions run on whatever device their inputs lie on; the CUDA
route of ``ops.py`` never calls them, but ``chip_smoke.py`` runs them on
the card to hold the kernel against them.
"""

from __future__ import annotations

import torch

R = 2654435761
MASK = 0xFFFFFFFF
_BLOCK = 4096
_R_BLOCK = pow(R, _BLOCK, 1 << 32)            # r^BLOCK mod 2^32


def _mulmod(a: torch.Tensor, b) -> torch.Tensor:
    """(a · b) mod 2^32 for int64 operands in [0, 2^32), overflow-free."""
    lo = a * (b & 0xFFFF)
    hi = (a * (b >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & MASK


def _powers(n: int, base: int) -> torch.Tensor:
    out = [0] * n
    acc = 1
    for i in range(n):
        out[i] = acc
        acc = (acc * base) & MASK
    return torch.tensor(out, dtype=torch.int64)


_POW_CACHE: dict = {}


def powers(n: int, base: int = R) -> torch.Tensor:
    """Host table [base^0, ..., base^(n-1)] mod 2^32 as int64 (CPU)."""
    key = (n, base)
    if key not in _POW_CACHE:
        _POW_CACHE[key] = _powers(n, base)
    return _POW_CACHE[key]


def as_bytes(x: torch.Tensor) -> torch.Tensor:
    """Flat uint8 view of any tensor's bytes (a copy only if ``x`` is not
    contiguous)."""
    flat = x.contiguous().reshape(-1)
    return flat if flat.dtype == torch.uint8 else flat.view(torch.uint8)


def as_words(x: torch.Tensor) -> torch.Tensor:
    """``x``'s bytes as a flat int32 tensor of lane bit patterns,
    zero-padded to a whole lane (a copy only where padding or alignment
    needs one).  The view is in host byte order, which is little-endian
    on every host PyTorch builds CUDA for."""
    raw = as_bytes(x)
    pad = (-raw.numel()) % 4
    if pad:
        raw = torch.cat([raw, raw.new_zeros(pad)])
    elif raw.storage_offset() % 4:
        raw = raw.clone()
    return raw.view(torch.int32)


def as_lanes(x: torch.Tensor) -> torch.Tensor:
    """Little-endian uint32 lanes of ``x``'s bytes, zero-padded, as int64
    values in [0, 2^32)."""
    return u32_lanes(as_words(x))


def u32_lanes(mat: torch.Tensor) -> torch.Tensor:
    """Widen a uint32 / int32 lane tensor (bit patterns) to int64 values
    in [0, 2^32)."""
    if mat.dtype == torch.int64:
        return mat & MASK
    if mat.dtype == torch.uint32:
        mat = mat.view(torch.int32)
    if mat.dtype != torch.int32:
        raise TypeError(f"expected 32-bit lanes, got {mat.dtype}")
    return mat.to(torch.int64) & MASK


def checksum_lanes_2d(mat: torch.Tensor) -> torch.Tensor:
    """Row-wise h() over a [rows, n] lane matrix -> int64[rows] in
    [0, 2^32).

    Zero-padded tail lanes contribute nothing to the polynomial, so rows
    of unequal logical length share one padded matrix and each row's
    value equals ``checksum_lanes`` of its unpadded lanes."""
    lanes = u32_lanes(mat)
    rows, n = lanes.shape
    dev = lanes.device
    if n == 0:
        return torch.zeros(rows, dtype=torch.int64, device=dev)
    if n <= _BLOCK:
        w = powers(n).to(dev)
        return _mulmod(lanes, w[None, :]).sum(dim=1) & MASK
    pad = (-n) % _BLOCK
    if pad:
        lanes = torch.cat([lanes, lanes.new_zeros(rows, pad)], dim=1)
    nb = lanes.shape[1] // _BLOCK
    blocks = lanes.view(rows, nb, _BLOCK)
    w = powers(_BLOCK).to(dev)
    partials = _mulmod(blocks, w[None, None, :]).sum(dim=2) & MASK
    facs = powers(nb, _R_BLOCK).to(dev)
    return _mulmod(partials, facs[None, :]).sum(dim=1) & MASK


def checksum_lanes(lanes: torch.Tensor) -> torch.Tensor:
    """h(lanes) for one flat lane vector -> int64 scalar in [0, 2^32)."""
    return checksum_lanes_2d(lanes.reshape(1, -1))[0]


def tensor_checksum(x: torch.Tensor) -> torch.Tensor:
    """Integrity hash of one tensor (any shape and dtype) -> int64 scalar
    in [0, 2^32)."""
    return checksum_lanes(as_lanes(x))
