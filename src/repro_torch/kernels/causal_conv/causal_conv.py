"""CUDA kernels of the Mamba2 mixer's causal conv1d, bias and SiLU: bind
and launch.

The kernels (``csrc/causal_conv.cu``) replace no TPU kernel: the JAX
package leaves ``_causal_conv`` to XLA, which fuses its shifted products;
eager PyTorch ran them as a dozen separate passes and autograd as a dozen
more.  Here one launch computes the forward and two the gradient, each
bound by HBM bytes:

* ``causal_conv_fwd_kernel`` reads x once through its strides (the mixer's
  x, B and C columns of in_proj's output, as they lie) and writes the
  activation once, contiguous, in x's dtype, with the sum of the taps and
  the bias taken in fp32 and rounded once after the SiLU.  Given the
  cached state it reads the state's rows as the rows before x and writes
  the new state, the last W-1 rows of ``cat(state, x)``.
* ``causal_conv_bwd_kernel`` recomputes the pre-activation, writes dx
  contiguous, and leaves fp32 partial sums of dw and db per (batch,
  ``TILE_ROWS``-row tile) in scratch; ``causal_conv_wsum_kernel`` adds them
  in a fixed order.  No atomics, so two calls give the same bits.

Both take fp32 or bf16 x at widths W <= ``MAX_WIDTH``, with taps in x's
dtype and the bias in fp32, a block a tile of ``TILE_ROWS`` rows by one
128-byte line of channels staged through shared memory.  Rows move as
16-byte loads and stores, so the channels come in whole groups of
``CHANNEL_MULTIPLE`` (``check`` refuses other counts), and a view whose
pointer, row or batch stride is no 16-byte multiple is copied first
(``aligned``, ``_readable``).  See the note at the top of the source.  It
is compiled with ``nvcc`` at first use and bound with ``ctypes``
(``kernels/nvcc.py``); nothing is compiled at import time.

``LAUNCHES`` counts forward calls that launched and ``BACKWARD_LAUNCHES``
gradient calls (two kernels each), each added right after a successful
call and nowhere else.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import nvcc

LAUNCHES = 0
BACKWARD_LAUNCHES = 0

SOURCE = nvcc.CSRC / "causal_conv.cu"
MAX_WIDTH = 4                      # kMaxWidth of the source
TILE_ROWS = 32                     # kTileL: rows a block and a partial
CHANNEL_MULTIPLE = 8               # kChannelMultiple: whole 16-byte words
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LAUNCH_NAMES = ("forward", "gradient", "partial sums")
MAX_GRID_YZ = 65535                # batch and sequence blocks span grid.z, .y

_fns: dict = {}


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.arcadia_causal_conv_fwd.argtypes = [p, ll, ll, p, p, p, p, p] + \
        [i] * 5 + [p]
    lib.arcadia_causal_conv_fwd.restype = i
    lib.arcadia_causal_conv_bwd.argtypes = [p, ll, ll, p, p, p, p, ll, ll,
                                            p, p, p, p] + [i] * 5 + [p]
    lib.arcadia_causal_conv_bwd.restype = i
    lib.arcadia_causal_conv_plan.argtypes = [ctypes.POINTER(ll)]
    lib.arcadia_causal_conv_plan.restype = None
    lib.arcadia_causal_conv_info.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.arcadia_causal_conv_info.restype = i


def _fn(name: str):
    """The C function ``name`` of the built library, looked up once."""
    fn = _fns.get(name)
    if fn is None:
        fn = _fns[name] = getattr(nvcc.load(SOURCE, _bind), name)
    return fn


def check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          state: Optional[torch.Tensor] = None) -> int:
    """Raise on inputs the kernels do not take (TypeError for a dtype,
    ValueError for a shape or layout); return the width W.  A function of
    dtypes and shapes only: it runs on CPU tensors too."""
    if x.dtype not in DTYPES:
        raise TypeError(f"causal conv kernel takes fp32 or bf16 x, got "
                        f"{x.dtype}")
    if w.dtype != x.dtype:
        raise TypeError(f"causal conv taps must be in x's dtype {x.dtype}, "
                        f"got {w.dtype}")
    if b.dtype != torch.float32:
        raise TypeError(f"causal conv bias must be fp32, got {b.dtype}")
    if state is not None and state.dtype != x.dtype:
        raise TypeError(f"causal conv state must be in x's dtype {x.dtype}, "
                        f"got {state.dtype}")
    if x.dim() != 3 or w.dim() != 2 or b.dim() != 1:
        raise ValueError(f"expected x [B,S,C], w [W,C], b [C], got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    B_, S, C = x.shape
    W = w.shape[0]
    if not 1 <= W <= MAX_WIDTH:
        raise ValueError(f"causal conv kernel takes widths 1..{MAX_WIDTH}, "
                         f"got {W}")
    if w.shape[1] != C or tuple(b.shape) != (C,):
        raise ValueError(f"causal conv shapes disagree: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    if C % CHANNEL_MULTIPLE:
        raise ValueError(f"causal conv kernel takes channels in multiples of "
                         f"{CHANNEL_MULTIPLE}, got {C}")
    if state is not None and tuple(state.shape) != (B_, W - 1, C):
        raise ValueError(f"causal conv state must be {(B_, W - 1, C)}, got "
                         f"{tuple(state.shape)}")
    for name, t in (("w", w), ("b", b), ("state", state)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"causal conv kernel needs a contiguous {name}")
    if B_ > MAX_GRID_YZ or -(-S // TILE_ROWS) > MAX_GRID_YZ:
        raise ValueError(f"causal conv kernel takes at most {MAX_GRID_YZ} "
                         f"batch rows and sequence blocks, got {B_}, {S}")
    return W


def _on_card(x: torch.Tensor, *others: Optional[torch.Tensor]) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"causal conv kernel needs CUDA tensors, got "
                         f"{x.device}")
    for t in others:
        if t is not None and t.device != x.device:
            raise ValueError(f"causal conv inputs on {t.device} and "
                             f"{x.device}")


def _readable(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the kernels read it as it lies (channels
    contiguous, ``aligned``), else a fresh contiguous copy (16-byte
    aligned, as every allocation is)."""
    if t.stride(-1) == 1 and aligned(t):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _strides(t: torch.Tensor) -> Tuple[int, int]:
    """(batch, row) element strides, 0 for a dimension of size 1 (it is
    never stepped)."""
    return tuple(0 if t.shape[k] == 1 else t.stride(k) for k in range(2))


def aligned(t: torch.Tensor) -> bool:
    """Whether the kernels' 16-byte words read the [B,S,C] view ``t`` as
    it lies: pointer and batch and row strides in bytes multiples of 16 (a
    function of layout only; it runs on CPU tensors too)."""
    el = t.element_size()
    return not (t.data_ptr() % 16 or any(s * el % 16 for s in _strides(t)))


def causal_conv_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     state: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """silu(causal conv1d(x) + b) of CUDA tensors in one launch -> (out
    [B,S,C] contiguous in x's dtype, the new state [B,W-1,C] where
    ``state`` is given, else None).  x [B,S,C] is read through its batch
    and row strides (a view whose channels are strided, or that is not
    ``aligned``, is copied first); w [W,C] in x's dtype, b [C] fp32 and
    state contiguous (``check``)."""
    global LAUNCHES
    W = check(x, w, b, state)
    _on_card(x, w, b, state)
    x = _readable(x)
    state = None if state is None else _readable(state)
    B_, S, C = x.shape
    out = torch.empty((B_, S, C), dtype=x.dtype, device=x.device)
    new_state = None if state is None else \
        torch.empty((B_, W - 1, C), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        if new_state is not None:
            new_state.copy_(torch.cat([state, x], dim=1)[:, S:])
        return out, new_state
    sxb, sxs = _strides(x)
    with torch.cuda.device(x.device):
        err = _fn("arcadia_causal_conv_fwd")(
            x.data_ptr(), sxb, sxs, w.data_ptr(), b.data_ptr(),
            None if state is None else state.data_ptr(), out.data_ptr(),
            None if new_state is None else new_state.data_ptr(),
            B_, S, C, W, DTYPES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"causal conv kernel launch failed: cudaError_t "
                           f"{err} (B={B_}, S={S}, C={C}, W={W}, {x.dtype})")
    LAUNCHES += 1
    return out, new_state


def causal_conv_backward_cuda(x: torch.Tensor, w: torch.Tensor,
                              b: torch.Tensor, dy: torch.Tensor,
                              state: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Gradient of ``causal_conv_cuda``'s out at dy [B,S,C] (x's dtype,
    read through its strides) -> (dx [B,S,C] contiguous in x's dtype, dw
    [W,C] in x's dtype, db [C] fp32).  Two launches: the gradient with
    fp32 partials of dw and db per (batch, ``TILE_ROWS``-row tile) in
    scratch, then their sum in a fixed order."""
    global BACKWARD_LAUNCHES
    W = check(x, w, b, state)
    _on_card(x, w, b, state, dy)
    if dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(f"dy must be {tuple(x.shape)} {x.dtype}, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    x, dy = _readable(x), _readable(dy)
    state = None if state is None else _readable(state)
    B_, S, C = x.shape
    dx = torch.empty((B_, S, C), dtype=x.dtype, device=x.device)
    dw = torch.empty((W, C), dtype=x.dtype, device=x.device)
    db = torch.empty((C,), dtype=torch.float32, device=x.device)
    if dx.numel() == 0:
        return dx, dw.zero_(), db.zero_()
    part = torch.empty((B_, -(-S // TILE_ROWS), W + 1, C),
                       dtype=torch.float32, device=x.device)
    sxb, sxs = _strides(x)
    sdb, sds = _strides(dy)
    with torch.cuda.device(x.device):
        err = _fn("arcadia_causal_conv_bwd")(
            x.data_ptr(), sxb, sxs, w.data_ptr(), b.data_ptr(),
            None if state is None else state.data_ptr(), dy.data_ptr(),
            sdb, sds, dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
            part.data_ptr(), B_, S, C, W, DTYPES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"causal conv gradient launch failed: cudaError_t"
                           f" {err} (B={B_}, S={S}, C={C}, W={W}, {x.dtype})")
    BACKWARD_LAUNCHES += 1
    return dx, dw, db


def plan() -> Tuple[int, int, int, int]:
    """``arcadia_causal_conv_plan`` of the built library: rows of a tile,
    the widest W (held to ``TILE_ROWS`` and ``MAX_WIDTH`` by the card
    tests), and the bf16 and fp32 channels of a tile."""
    out = (ctypes.c_longlong * 4)()
    _fn("arcadia_causal_conv_plan")(out)
    return tuple(int(v) for v in out)


def kernel_info(width: int, dtype: torch.dtype) -> list:
    """``cudaFuncGetAttributes`` of the forward, gradient and partial-sum
    kernels at (width, dtype): a dict each with
    registers a thread, local (spill) bytes, static shared bytes and max
    threads a block."""
    out = []
    for k, name in enumerate(LAUNCH_NAMES):
        vals = (ctypes.c_int * 4)()
        err = _fn("arcadia_causal_conv_info")(k, width, DTYPES[dtype], vals)
        if err != 0:
            raise RuntimeError(f"cudaFuncGetAttributes failed ({err}) for "
                               f"the {name} kernel")
        out.append(dict(launch=name, registers=vals[0], local_bytes=vals[1],
                        static_shared_bytes=vals[2], max_threads=vals[3]))
    return out
