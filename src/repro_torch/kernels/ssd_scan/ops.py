"""Routing of the SSD scan by the tensors' device.

CPU tensors go to the plain PyTorch version (``ref.py``), CUDA tensors to
the hand-written kernels (``ssd_scan.py``), anything else raises.  Nothing
falls back: a CUDA tensor never reaches the plain version, and a kernel
that cannot build or launch raises.

On the card ``ssd_scan.route`` picks the kernel by dtype, shape and
layout: bf16 at widths of 16·k and chunks of 64·k, 16-byte aligned, to
``csrc/ssd_scan_tc.cu``; fp32 and the rest of bf16 to the "cuda_cores"
route, ``csrc/ssd_scan.cu``.  Both run the same three launches (chunk
states, state passing, chunk output) with their products on the tensor
cores (mma.sync; the "cuda_cores" route keeps its name): fp32 as three
TF32 products, bf16 with the tensor-core route's roundings.  Both read xh,
Bm and Cm through their strides, so the mixer's views of its conv output
go in as they are, whatever their dtype or alignment.

The scan of CUDA tensors is a ``torch.autograd.Function``: its forward is
the kernel above, its backward the hand-written backward kernel that
``ssd_scan.backward_route`` picks inside ``ssd_scan.ssd_backward_cuda``
(``csrc/ssd_scan_bwd_tc.cu`` for bf16 at widths of 16·k and chunks of
64·k, ``csrc/ssd_scan_bwd.cu`` — the "cuda_cores" route, seven launches
on the tensor cores — for the rest; both read the mixer's views as they
are).  CPU tensors run ``ref.ssd_reference`` under plain autograd.

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
