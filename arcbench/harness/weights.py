"""The cells' weights, made by the benchmark from ``--seed``.

Every leaf of the port's parameter tree is drawn on the device in one
call from a generator seeded by (seed, leaf index), in the dtype it is
stored in.  So any one leaf can be drawn again alone, bit for bit, which
is how the reference and the checks get the weights the program started
from without a copy being kept.

Distributions (GPT-2's and Mamba2's conventions): matrices and the
embedding N(0, 0.02^2); norm gains, biases and the conv bias 0 (the
gains are stored as w in a 1 + w gain); D_skip 1; A_log = log U(1, 16);
dt_bias the inverse softplus of U(1e-3, 1e-1).
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

STD = 0.02


def leaf_seed(seed: int, index: int) -> int:
    return int(np.random.SeedSequence([seed, index, 0x3E1])
               .generate_state(1, np.uint64)[0] >> 1)


def parts(name: str):
    """A leaf name's keys: ``['blocks']['l0']['ln1']['w']`` -> blocks, l0,
    ln1, w."""
    return re.findall(r"\['([^']*)'\]", name)


def draw(name: str, shape, dtype: torch.dtype, seed: int, index: int,
         device) -> torch.Tensor:
    """The leaf ``name`` (the ``index``-th in tree order) on ``device``."""
    keys = [k.lower() for k in parts(name)]
    leaf = keys[-1]
    if any("norm" in k or k.startswith("ln") or k.startswith("post_ln")
           for k in keys):
        return torch.zeros(shape, dtype=dtype, device=device)
    if leaf == "d_skip":
        return torch.ones(shape, dtype=dtype, device=device)
    if leaf.startswith("b") or leaf == "conv_b":
        return torch.zeros(shape, dtype=dtype, device=device)
    g = torch.Generator(device=device).manual_seed(leaf_seed(seed, index))
    if leaf in ("a_log", "dt_bias"):
        u = torch.rand(shape, generator=g, dtype=torch.float32, device=device)
        if leaf == "a_log":
            return torch.log(1.0 + 15.0 * u).to(dtype)
        u = 1e-3 + (1e-1 - 1e-3) * u
        return (u + torch.log(-torch.expm1(-u))).to(dtype)
    return torch.randn(shape, generator=g, dtype=dtype,
                       device=device).mul_(STD)


def leaves(specs, seed: int, device) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every leaf of ``specs`` ((name, shape, dtype) in
    tree order), drawn one at a time."""
    for i, (name, shape, dtype) in enumerate(specs):
        yield name, draw(name, shape, dtype, seed, i, device)


def make(specs, seed: int, device) -> Dict[str, torch.Tensor]:
    return dict(leaves(specs, seed, device))


def port_specs(cfg):
    """(name, shape, dtype) of the port's parameter tree for ``cfg``."""
    from repro_torch.models import model as M
    from repro_torch.tree import leaf_paths
    return [(n, tuple(s.shape), s.dtype)
            for n, s in leaf_paths(M.param_specs(cfg))]


def as_tree(flat: Dict[str, torch.Tensor], cfg):
    """The flat (name -> tensor) weights in the port's tree structure."""
    from repro_torch.models import model as M
    from repro_torch.tree import map_with_path
    return map_with_path(lambda n, _: flat[n], M.param_specs(cfg))
