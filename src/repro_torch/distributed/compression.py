"""Gradient compression: int8 ring all-reduce (quantize → all_to_all →
local int32 accumulate → requantize → all_gather), the JAX package's
``distributed/compression.py`` over a ``torch.distributed`` group.

A plain all-reduce moves fp32 on the wire; this moves int8 chunks plus one
tiny fp32 scale exchange — ~4× fewer bytes for cross-pod gradient
reduction.  Quantization is symmetric per-shard-max with optional
stochastic rounding (unbiased in expectation), drawn from an explicit
``torch.Generator``.

Every rank calls ``compressed_psum`` with its own contribution and gets
the (quantized) sum of all of them.  The steps and their arithmetic are
the JAX module's: ``pmax`` is ``all_reduce(MAX)``, and ``torch.round``
rounds half to even as ``jnp.round`` does, so deterministic rounding gives
the JAX package's int8 codes.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _quantize(x, scale, generator: Optional[torch.Generator] = None):
    y = x / torch.clamp(scale, min=1e-30)
    if generator is not None:
        y = torch.floor(y + torch.rand(y.shape, generator=generator,
                                       dtype=y.dtype, device=y.device))
    else:
        y = torch.round(y)
    return torch.clamp(y, -127, 127).to(torch.int8)


def _requantize(acc, scale, n: int):
    """The partial sum of int8 codes back to int8 at the grown scale
    scale·n; returns (codes, scale·n)."""
    scale2 = scale * n
    q2 = torch.clamp(torch.round(acc.float() * scale
                                 / torch.clamp(scale2, min=1e-30)),
                     -127, 127).to(torch.int8)
    return q2, scale2


def compressed_psum(x: torch.Tensor, group=None,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """int8 ring all-reduce of ``x`` over ``group`` (default: the world).
    x's element count must be divisible by the group size (pad upstream).
    ``generator`` (on x's device) turns on stochastic rounding."""
    n = dist.get_world_size(group)
    flat = x.reshape(-1)
    if flat.numel() % n:
        raise ValueError(f"{flat.numel()} values do not split over {n} ranks")
    chunk = flat.numel() // n
    xs = flat.reshape(n, chunk)                     # my contribution, split
    # global symmetric scale (one tiny fp32 all-reduce)
    amax = torch.max(torch.abs(flat))
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = amax / 127.0
    q = _quantize(xs, scale, generator)             # [n, chunk] int8
    # reduce-scatter phase: chunk j of every rank lands on rank j
    recv = torch.empty_like(q)
    dist.all_to_all_single(recv, q, group=group)
    acc = torch.sum(recv.to(torch.int32), dim=0)    # local accumulate
    # requantize the partial sum and all-gather int8 (scale grows by n)
    q2, scale2 = _requantize(acc, scale, n)
    gathered = torch.empty(n * chunk, dtype=torch.int8, device=x.device)
    dist.all_gather_into_tensor(gathered, q2, group=group)
    out = gathered.float() * scale2
    return out.reshape(x.shape).to(x.dtype)


def compressed_psum_reference(contribs: Sequence[torch.Tensor],
                              generators: Optional[Sequence] = None
                              ) -> torch.Tensor:
    """The plain version: what ``compressed_psum`` returns on every rank
    when rank r contributes ``contribs[r]`` (with ``generators[r]``), the
    same quantize–accumulate–requantize–dequantize steps on one device with
    no collective."""
    n = len(contribs)
    xs = [c.reshape(n, -1) for c in contribs]
    scale = torch.max(torch.stack([torch.max(torch.abs(c)) for c in xs])
                      ) / 127.0
    gens = generators or [None] * n
    q = torch.stack([_quantize(c, scale, g) for c, g in zip(xs, gens)])
    acc = torch.sum(q.to(torch.int32), dim=0)       # [n(chunks), chunk]
    q2, scale2 = _requantize(acc, scale, n)
    out = q2.reshape(-1).float() * scale2
    return out.reshape(contribs[0].shape).to(contribs[0].dtype)


def quantized_allreduce(x: torch.Tensor, mesh: DeviceMesh, axis: str,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """``compressed_psum`` of this rank's ``x`` over the group of mesh axis
    ``axis`` (e.g. per-pod gradient replicas)."""
    return compressed_psum(x, mesh.get_group(axis), generator)


__all__ = ["compressed_psum", "compressed_psum_reference",
           "quantized_allreduce"]
