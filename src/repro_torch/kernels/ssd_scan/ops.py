"""Routing of the SSD scan by the tensors' device.

CPU tensors go to the plain PyTorch version (``ref.py``), CUDA tensors to
the hand-written kernels (``ssd_scan.py``), anything else raises.  Nothing
falls back: a CUDA tensor never reaches the plain version, and a kernel
that cannot build or launch raises.

On the card ``ssd_scan.route`` picks the kernel by dtype, shape and
layout.  The tensor-core route reads xh, Bm and Cm through their strides
(the mixer's views of its conv output go in as they are).  The CUDA-core
route copies views to contiguous tensors for its kernel: that is the
fp32 path, and bf16 views whose pointers or strides are not 16-byte
aligned, which the router sends there.

``ssd_decode`` (one token) is plain PyTorch on either device: three small
einsums, no kernel, as in the JAX package.  The kernels' launch counts
are ``ssd_scan.LAUNCHES`` (one per scan) and each route's
``ssd_scan.TENSOR_CORE_LAUNCHES`` / ``ssd_scan.CUDA_CORE_LAUNCHES``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import ref
from . import ssd_scan


def ssd(xh, dt, A_log, Bm, Cm, chunk: int
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan -> (y [B,S,H,P] in xh's dtype, state [B,H,P,N]
    fp32).  dt and A_log are taken in fp32, as the scan computes."""
    kind = xh.device.type
    if kind == "cpu":
        return ref.ssd_reference(xh, dt, A_log, Bm, Cm, chunk)
    if kind == "cuda":
        return ssd_scan.ssd_cuda(xh, dt.float().contiguous(),
                                 A_log.float().contiguous(), Bm, Cm, chunk)
    raise ValueError(f"no SSD route for device {xh.device}")


def ssd_decode(xh, dt, A_log, Bm, Cm, state
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence (plain PyTorch on every device)."""
    if xh.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no SSD route for device {xh.device}")
    return ref.ssd_decode_reference(xh, dt, A_log, Bm, Cm, state)
