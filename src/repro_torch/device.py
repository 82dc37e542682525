"""Where the port runs: every entry point takes a ``device``, ``"cuda"`` by
default."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the default of every
    entry point) needs a card and raises without one — there is no silent
    fall back to the CPU; ``"cpu"`` selects the plain versions of the
    kernels."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but no CUDA device is available "
                "(pass device='cpu' to run the plain versions)")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
