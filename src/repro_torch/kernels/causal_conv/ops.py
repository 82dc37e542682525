"""Routing of the Mamba2 mixer's causal conv1d, bias and SiLU.

CPU tensors go to the plain version (``ref.causal_conv_reference``, the
JAX package's formula, which the CPU tests hold to it), under plain
autograd.  CUDA tensors go to the hand-written kernels
(``causal_conv.py``) as a ``torch.autograd.Function`` whose backward is
the gradient kernel; what the kernels do not take (``causal_conv.check``:
a dtype other than fp32 or bf16, W > ``causal_conv.MAX_WIDTH``, channels
in no multiple of 8) and a cached state that itself needs a gradient are
refused, never sent to the plain version.  Training, prefill and decode
take the same kernel.

The kernel route takes the taps in x's dtype and the bias in fp32 (cast
here, differentiably) and returns no state where none was given; the
plain route returns the padded input's last rows as the JAX package
does.  The kernels' counts are ``causal_conv.LAUNCHES`` (forward calls)
and ``causal_conv.BACKWARD_LAUNCHES`` (gradient calls).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import causal_conv as kernels
from . import ref


class _Conv(torch.autograd.Function):
    """The conv on the card, with the gradient kernel as its backward.
    Returns out alone without a state, (out, new state) with one."""

    @staticmethod
    def forward(ctx, x, w, b, state):
        if ctx.needs_input_grad[3]:
            raise ValueError("the causal conv kernels give no gradient of "
                             "the cached state")
        ctx.set_materialize_grads(False)
        out, new_state = kernels.causal_conv_cuda(x, w, b, state)
        ctx.save_for_backward(x, w, b, state)
        if new_state is None:
            return out
        ctx.mark_non_differentiable(new_state)
        return out, new_state

    @staticmethod
    def backward(ctx, dy, *_):
        if dy is None:
            return None, None, None, None
        x, w, b, state = ctx.saved_tensors
        dx, dw, db = kernels.causal_conv_backward_cuda(x, w, b, dy, state)
        return dx, dw, db, None


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Depthwise causal conv1d of x [B,S,C] (any strides) with taps w
    [W,C] and bias b [C], then SiLU -> (out [B,S,C] in x's dtype, new
    state [B,W-1,C] or None).  With ``state`` ([B,W-1,C]) runs
    incrementally.  Differentiable on both devices."""
    kind = x.device.type
    if kind == "cpu":
        return ref.causal_conv_reference(x, w, b, state)
    if kind != "cuda":
        raise ValueError(f"no causal conv route for device {x.device}")
    w = w.to(x.dtype).contiguous()
    b = b.float().contiguous()
    if state is None:
        return _Conv.apply(x, w, b, None), None
    return _Conv.apply(x, w, b, state.to(x.dtype).contiguous())
