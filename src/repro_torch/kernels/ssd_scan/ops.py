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

The scan of CUDA tensors is a ``torch.autograd.Function``: its forward is
the kernel above, its backward the hand-written backward kernel that
``ssd_scan.backward_route`` picks inside ``ssd_scan.ssd_backward_cuda``
(tensor cores for bf16 at widths of 16·k and chunks of 64·k, reading the
mixer's views as they are; CUDA cores for the rest, on contiguous
copies).  CPU tensors run ``ref.ssd_reference`` under plain autograd.

``ssd_decode`` (one token) is plain PyTorch on either device: three small
einsums, no kernel, as in the JAX package.  The kernels' launch counts
are ``ssd_scan.LAUNCHES`` (one per scan) and each route's
``ssd_scan.TENSOR_CORE_LAUNCHES`` / ``ssd_scan.CUDA_CORE_LAUNCHES``, and
``ssd_scan.BACKWARD_LAUNCHES`` (one per gradient) with each backward
route's ``BACKWARD_TENSOR_CORE_LAUNCHES`` / ``BACKWARD_CUDA_CORE_LAUNCHES``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import ref
from . import ssd_scan


class _Scan(torch.autograd.Function):
    """The scan on the card, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, xh, dt, A_log, Bm, Cm, chunk):
        ctx.set_materialize_grads(False)
        dt, A_log = dt.contiguous(), A_log.contiguous()
        ctx.chunk = chunk
        ctx.save_for_backward(xh, dt, A_log, Bm, Cm)
        return ssd_scan.ssd_cuda(xh, dt, A_log, Bm, Cm, chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        xh, dt, A_log, Bm, Cm = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(xh)
        grads = ssd_scan.ssd_backward_cuda(xh, dt, A_log, Bm, Cm, dy, dstate,
                                           ctx.chunk)
        return (*grads, None)


def ssd(xh, dt, A_log, Bm, Cm, chunk: int
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan -> (y [B,S,H,P] in xh's dtype, state [B,H,P,N]
    fp32).  dt and A_log are taken in fp32, as the scan computes.
    Differentiable on both devices."""
    kind = xh.device.type
    if kind == "cpu":
        return ref.ssd_reference(xh, dt, A_log, Bm, Cm, chunk)
    if kind == "cuda":
        return _Scan.apply(xh, dt.float(), A_log.float(), Bm, Cm, chunk)
    raise ValueError(f"no SSD route for device {xh.device}")


def ssd_decode(xh, dt, A_log, Bm, Cm, state
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence (plain PyTorch on every device)."""
    if xh.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no SSD route for device {xh.device}")
    return ref.ssd_decode_reference(xh, dt, A_log, Bm, Cm, state)
