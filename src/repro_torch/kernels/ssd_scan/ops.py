"""Routing of the SSD scan by the tensors' device.

CPU tensors go to the plain PyTorch version (``ref.py``), CUDA tensors to
the hand-written kernel (``ssd_scan.py``), anything else raises.  Nothing
falls back: a CUDA tensor never reaches the plain version, and a kernel
that cannot build or launch raises.

``ssd_decode`` (one token) is plain PyTorch on either device: three small
einsums, no kernel, as in the JAX package.  The kernel's launch count is
``ssd_scan.LAUNCHES``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import ref
from .ssd_scan import ssd_cuda


def ssd(xh, dt, A_log, Bm, Cm, chunk: int
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan -> (y [B,S,H,P] in xh's dtype, state [B,H,P,N]
    fp32).  dt and A_log are taken in fp32, as the scan computes."""
    kind = xh.device.type
    if kind == "cpu":
        return ref.ssd_reference(xh, dt, A_log, Bm, Cm, chunk)
    if kind == "cuda":
        return ssd_cuda(xh.contiguous(), dt.float().contiguous(),
                        A_log.float().contiguous(), Bm.contiguous(),
                        Cm.contiguous(), chunk)
    raise ValueError(f"no SSD route for device {xh.device}")


def ssd_decode(xh, dt, A_log, Bm, Cm, state
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence (plain PyTorch on every device)."""
    if xh.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no SSD route for device {xh.device}")
    return ref.ssd_decode_reference(xh, dt, A_log, Bm, Cm, state)
