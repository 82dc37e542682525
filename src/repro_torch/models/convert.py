"""Params between the two packages, through numpy.

``params_from_numpy`` turns the JAX package's params, given as nested
dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``),
into the port's: the same nesting, the same names, the same stacked
leading block axis, each leaf a tensor on ``device`` with its own dtype.
``params_to_numpy`` goes back, and ``train_state_from_numpy`` /
``train_state_to_numpy`` carry a whole train state.  bf16 leaves travel
as ``ml_dtypes`` bfloat16 arrays on the numpy side (what ``np.asarray`` of
a JAX bf16 array gives) and as torch.bfloat16 on the port's.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..tree import tree_map


def _is_bf16(dtype: np.dtype) -> bool:
    return dtype.name == "bfloat16"


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """One numpy array -> a tensor of its dtype on ``device`` (the card
    unless the caller passes the CPU)."""
    device = resolve_device(device)
    a = np.asarray(a)
    if _is_bf16(a.dtype):
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes                  # what numpy needs to hold bf16
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.numpy().copy()


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """numpy-leaf params -> port params on ``device`` (the card unless the
    caller passes the CPU)."""
    device = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


def params_to_numpy(tree: Any) -> Any:
    """Port params -> the same tree with numpy leaves (on the host)."""
    return tree_map(tensor_to_numpy, tree)


def train_state_from_numpy(state: Any, device="cuda") -> Any:
    """The JAX package's train state ``{"params", "opt", "step"}`` with
    numpy leaves (``jax.tree_util.tree_map(np.asarray, state)``) -> the
    port's, on ``device``: the same trees, ``step`` an int32 scalar
    tensor.  Both packages then start a step from the same state."""
    device = resolve_device(device)
    return {"params": params_from_numpy(state["params"], device),
            "opt": params_from_numpy(state["opt"], device),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device)}


def train_state_to_numpy(state: Any) -> Any:
    """The port's train state -> numpy leaves, ``step`` an int32 scalar."""
    return {"params": params_to_numpy(state["params"]),
            "opt": params_to_numpy(state["opt"]),
            "step": np.asarray(int(state["step"]), np.int32)}
