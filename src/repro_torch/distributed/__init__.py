"""The distributed layer of the port (the JAX package's ``distributed/``):
logical-axis sharding rules over a ``DeviceMesh`` (``sharding``), the int8
compressed all-reduce (``compression``) and the GPipe schedule
(``pipeline``); MoE expert parallelism lives in ``models/layers.py``.

Every collective runs over a ``torch.distributed`` process group: NCCL for
``device_type="cuda"`` (the default of every entry point) and gloo for
``"cpu"``; the dry run alone uses the fake group, which moves nothing.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from ..device import resolve_device


def backend_for(device_type: str = "cuda") -> str:
    """The process-group backend for ``device_type``: "nccl" for the card
    (raises without one, as ``resolve_device`` does), "gloo" for the CPU."""
    return "nccl" if resolve_device(device_type).type == "cuda" else "gloo"


@contextlib.contextmanager
def one_rank_group(device_type: str = "cuda"):
    """A default process group of one rank on this process's device (NCCL on
    the card, gloo on the CPU), bootstrapped from an in-memory store and
    destroyed on exit.  At one rank a collective moves no bytes over a link:
    it runs the program's collective path on one device."""
    backend = backend_for(device_type)
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1, **kw)
    try:
        yield
    finally:
        dist.destroy_process_group()


__all__ = ["backend_for", "one_rank_group"]
