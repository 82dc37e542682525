"""Plain PyTorch versions of the Mamba2 mixer's depthwise causal conv1d.

For x [B,S,C], taps w [W,C], bias b [C] and an optional cached state
[B,W-1,C] (the inputs before x's first row; zero without one):

    pre[t] = b + Σ_{i<W} w[i] · x[t - W + 1 + i]        out = silu(pre)

``causal_conv_reference`` is the JAX package's ``_causal_conv``
(``repro/models/layers.py``) written in PyTorch: the taps multiplied and
summed in x's dtype, the bias added in fp32, SiLU in fp32, rounded back to
x's dtype.  CPU tensors run it, under plain autograd, and it is what the
CPU tests hold to the JAX package.

``causal_conv_fp32_reference`` is the arithmetic of the CUDA kernels
(``csrc/causal_conv.cu``): the sum started from the bias and taken in
fp32, SiLU in fp32, one rounding to x's dtype.  The card tests and
``chip_smoke.py`` hold the forward kernel to it; with ``torch.autograd``
in fp32 it is the yardstick of the gradient kernel too.

Both return (out [B,S,C] in x's dtype, new state), the new state being the
last W-1 rows of ``cat(state or zeros, x)`` in x's dtype (the plain
version keeps the JAX package's: none for W = 1 without a state).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def causal_conv_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          state: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Depthwise causal conv1d.  x [B,S,C]; w [W,C].  With ``state``
    ([B,W-1,C]) runs incrementally and returns the new state.  The taps
    are summed elementwise in x's dtype (no convolution library call, so
    no TF32 on the card)."""
    W = w.shape[0]
    S = x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, W - 1, 0))
        new_state = xp[:, -(W - 1):, :] if W > 1 else None
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
        new_state = xp[:, -(W - 1):, :]
    out = sum(xp[:, i:i + S, :] * w[i] for i in range(W))
    return F.silu((out + b).float()).to(x.dtype), new_state


def causal_conv_fp32_reference(x: torch.Tensor, w: torch.Tensor,
                               b: torch.Tensor,
                               state: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor,
                                          Optional[torch.Tensor]]:
    """The kernels' arithmetic: ``b + Σ w[i]·x[t-W+1+i]`` in fp32 from the
    bias up, the oldest tap first, fp32 SiLU, one rounding to x's dtype
    (float64 inputs compute in float64)."""
    W = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0)) if state is None else \
        torch.cat([state.to(x.dtype), x], dim=1)
    f = torch.float64 if x.dtype == torch.float64 else torch.float32
    acc = b.to(f).expand(x.shape[0], S, -1)
    for i in range(W):
        acc = acc + w[i].to(f) * xp[:, i:i + S, :].to(f)
    return F.silu(acc).to(x.dtype), xp[:, xp.shape[1] - (W - 1):, :]
