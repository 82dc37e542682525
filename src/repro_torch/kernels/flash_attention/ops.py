"""Routing of attention by the tensors' device.

CPU tensors go to the plain PyTorch version (``ref.py``), CUDA tensors to
the hand-written kernels (``flash_attention.py``: bf16 at the (D, Dv)
pairs (64, 64), (80, 80), (128, 128), (192, 128) and (256, 256) with
16-byte aligned views to the wgmma kernels, the rest — fp32, other
pairs, views TMA cannot read — to the ``"cuda_cores"`` route, whose
kernels also run on the tensor cores, through ``mma.sync``: fp32 products
as three TF32 products each, bf16 products with fp32 sums), anything
else raises.  Nothing falls back: a CUDA tensor never reaches
the plain version, and a kernel that cannot build or launch, or an input
it does not take (a dtype other than fp32 or bf16, a head dim above 256,
a value head dim above q's, a head dim that is not contiguous), raises.
The kernels' launch count is ``flash_attention.LAUNCHES``, each route's
``TENSOR_CORE_LAUNCHES`` and ``CUDA_CORE_LAUNCHES``.

Where a gradient is needed, attention is ``_Flash``, a
``torch.autograd.Function`` on either device: on the card its forward is
the kernel with its per-row log-sum-exp, its backward the backward
kernels (``flash_attention_backward_cuda``: three launches on the route
``backward_route`` picks — wgmma for bf16 at the tensor-core pairs with
aligned views, else the mma.sync ``"cuda_cores"`` route — counted by
``flash_attention.BACKWARD_LAUNCHES`` per call and
``BACKWARD_TENSOR_CORE_LAUNCHES`` / ``BACKWARD_CUDA_CORE_LAUNCHES`` per
route); on the CPU the plain
forward, ``ref.attention_lse_reference`` and
``ref.attention_backward_reference``, so the CPU tests hold the same
plumbing (the saved lse, the group sums, the views) to ``jax.grad``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .flash_attention import flash_attention_backward_cuda, \
    flash_attention_cuda


class _Flash(torch.autograd.Function):
    """Attention with its hand-written gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap, scale):
        kw = dict(causal=causal, window=window, cap=cap, scale=scale)
        if q.device.type == "cuda":
            o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        else:
            o = ref.attention_reference(q, k, v, **kw)
            lse = ref.attention_lse_reference(q, k, **kw)
        ctx.kw = kw
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "cuda":
            grads = flash_attention_backward_cuda(q, k, v, o, lse, do,
                                                  **ctx.kw)
        else:
            grads = ref.attention_backward_reference(q, k, v, o, lse, do,
                                                     **ctx.kw)
        return (*grads, None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    cap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q [B,H,S,D]; k [B,KV,S,D], v [B,KV,S,Dv] with Dv <= D ->
    [B,H,S,Dv]; query head h reads kv head h // (H // KV).
    Differentiable on both devices."""
    kind = q.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no attention route for device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Flash.apply(q, k, v, causal, window, cap, scale)
    if kind == "cpu":
        return ref.attention_reference(q, k, v, causal=causal, window=window,
                                       cap=cap, scale=scale)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                cap=cap, scale=scale)
