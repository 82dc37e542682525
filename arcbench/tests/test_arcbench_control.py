"""The control — the reference one precision below the configuration's
bfloat16, in the program's place — fails the cell's limits; at a size the
CPU holds here, and at the cell's own size on the card."""

import pytest
import torch

from arcbench.harness import main as hm

from .common import SEED, TINY, tiny_cell
from .control import readings


# what the CPU holds: the train cells' tiny models; the served model whole
# (its published widths and depth) at short prompts, with 48 served tokens
# in the sample, where the widest gap is of the cell's scale
SIZES = {"mamba2-130m.train": (TINY["mamba2-130m.train"][0], None, {}),
         "starcoder2-3b.train": (TINY["starcoder2-3b.train"][0], None, {}),
         "mamba2-130m.prefill": ({}, dict(batch=8, lengths=[256]),
                                 {"sample_batches": 6})}


@pytest.mark.parametrize("name", list(SIZES))
def test_control_fails_a_limit(name):
    cell = tiny_cell(name)
    lim = hm.limits(cell)
    over, mix, check = SIZES[name]
    cell.settings["check"].update(check)
    for seed in (SEED, SEED + 1, SEED + 2):
        r = readings(cell, seed, "cpu", overrides=over,
                     mix=mix or cell.traffic)
        assert any(v > lim[k] for k, v in r["control"].items()
                   if k in lim), r


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mamba2-130m.train",
                                  "starcoder2-3b.train",
                                  "mamba2-130m.prefill"])
def test_control_fails_a_limit_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from arcbench.harness import spec
    cell = spec.cell(name)
    lim = hm.limits(cell)
    for seed in (SEED, SEED + 1, SEED + 2):
        r = readings(cell, seed, "cuda")
        assert any(v > lim[k] for k, v in r["control"].items()
                   if k in lim), r
