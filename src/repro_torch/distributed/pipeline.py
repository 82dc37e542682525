"""GPipe-style pipeline parallelism over a mesh axis (the JAX package's
``distributed/pipeline.py``, shard_map + ppermute there, point-to-point
sends here).

Stages hold disjoint layer slices (leading ``n_stages`` dim of the stage
params).  Microbatches stream through: at tick t, stage i processes
microbatch t-i; activations hop stages by ``batch_isend_irecv``.  Bubble
fraction = (S-1)/(M+S-1) — pick M >= 4·S.

The schedule is static and the JAX package's: n_micro + n - 1 ticks; at
every tick every stage runs ``stage_fn`` (stage 0 on microbatch
min(t, n_micro - 1), the others on what the previous stage sent), then
hands its output on (s -> s+1 mod n); the last stage emits microbatch
t - (n - 1); an all-reduce of the masked outputs (the JAX package's psum)
gives every rank the last stage's outputs.  With one stage the hop is a
local copy (no send or receive is issued), so the result is the stage run
on each microbatch in turn.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..tree import tree_map


def _stage_slice(leaf, i: int):
    """This stage's slice of a stacked leaf: a DTensor sharded over the
    pipeline axis gives its local [1, ...] block, a plain tensor holding
    every stage gives row i."""
    if isinstance(leaf, DTensor):
        return leaf.to_local()[0]
    return leaf[i]


def pipeline_forward(stage_fn: Callable, stage_params: Any, x: torch.Tensor,
                     *, mesh: DeviceMesh, axis: str, n_micro: int
                     ) -> torch.Tensor:
    """stage_params: tree with leading dim n_stages on every leaf; x
    [n_micro, mb, ...], the same on every rank.  Returns y [n_micro, mb,
    ...], the same on every rank of the axis."""
    group = mesh.get_group(axis)
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    i = mesh.get_local_rank(axis)
    ranks = dist.get_process_group_ranks(group)
    p_local = tree_map(lambda a: _stage_slice(a, i), stage_params)
    state = torch.zeros_like(x[0])
    out = torch.zeros_like(x)
    for t in range(n_micro + n - 1):                 # static schedule
        inp = x[min(t, n_micro - 1)] if i == 0 else state
        y = stage_fn(p_local, inp)
        if n == 1:
            state = y
        else:
            state = torch.empty_like(y)
            ops = [dist.P2POp(dist.isend, y.contiguous(), ranks[(i + 1) % n],
                              group),
                   dist.P2POp(dist.irecv, state, ranks[(i - 1) % n], group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        emit = t - (n - 1)
        if emit >= 0 and i == n - 1:
            out[emit] = y
    # broadcast the last stage's outputs to every stage
    dist.all_reduce(out, group=group)
    return out


__all__ = ["pipeline_forward"]
