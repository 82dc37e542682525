"""Production mesh construction (the JAX package's ``launch/mesh.py``).

Functions, never module-level constants: importing this module touches
no process group.  Both build a ``DeviceMesh`` over the default process
group, which must exist and hold exactly the mesh's ranks (NCCL ranks on
the cards; the dry run's fake group of 256 or 512 ranks on the CPU).
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..distributed import backend_for


def _mesh(device_type: str, shape, names) -> DeviceMesh:
    backend_for(device_type)                 # "cuda" without a card raises
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs a process group of "
            f"that many ranks: call init_process_group first")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """Single pod: 256 ranks as (data=16, model=16).  Multi-pod: 2 pods ×
    256 as (pod=2, data=16, model=16); the pod axis carries data-parallel
    gradient reduction and the journal-replication domain, data and model
    stay inside a pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def make_smoke_mesh(n: Optional[int] = None,
                    device_type: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh over ``n`` ranks (default: the whole default
    group); the model axis is the first of 4, 2 and 1 that divides n."""
    if n is None:
        if not dist.is_initialized():
            raise RuntimeError("make_smoke_mesh needs a process group: call "
                               "init_process_group first")
        n = dist.get_world_size()
    model = next(m for m in (4, 2, 1) if n % m == 0)
    return _mesh(device_type, (n // model, model), ("data", "model"))


__all__ = ["make_production_mesh", "make_smoke_mesh"]
