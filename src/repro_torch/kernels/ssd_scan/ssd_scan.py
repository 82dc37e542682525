"""CUDA kernels of the Mamba2 SSD chunked scan: bind and launch.

The kernels replace the JAX package's Pallas TPU kernel ``_ssd_kernel``
(``repro/kernels/ssd_scan/ssd_scan.py``).  Two routes, chosen by dtype,
shape and layout (``route``):

* ``"tensor_cores"`` (``csrc/ssd_scan_tc.cu``) — bf16 with head dim P and
  state dim N multiples of 16 (P <= 128, N <= 256), a chunk that is a
  multiple of the 64-row tile, and xh, Bm and Cm whose pointers are
  16-byte aligned and whose strides are multiples of 8 elements with the
  last dimension contiguous: three launches — chunk states, state
  passing, chunk output — with every chunk in parallel and the products
  on the tensor cores (mma.sync).  The inputs are read through their
  strides, so the mixer's views of its conv output go in without a copy.
* ``"cuda_cores"`` (``csrc/ssd_scan.cu``) — fp32, and bf16 at other widths
  or layouts: one block per (batch, head) walks its chunks in order with
  the running state in shared memory, fp32 products out of shared memory;
  it takes contiguous inputs, so this route copies views.

See the notes at the top of the sources.  Each source is compiled with
``nvcc`` at first use and bound with ``ctypes`` (``kernels/nvcc.py``);
nothing is compiled at import time.

``LAUNCHES`` counts scan calls that launched, one per call whatever the
number of kernels; ``TENSOR_CORE_LAUNCHES`` and ``CUDA_CORE_LAUNCHES`` each
route's.  ``ssd_cuda`` adds one to ``LAUNCHES`` and to its route's count
right after each successful call and nowhere else.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import nvcc

LAUNCHES = 0
TENSOR_CORE_LAUNCHES = 0
CUDA_CORE_LAUNCHES = 0

SOURCE = nvcc.CSRC / "ssd_scan.cu"
TC_SOURCE = nvcc.CSRC / "ssd_scan_tc.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROW_TILE = 64                      # kTile of ssd_scan_tc.cu
PAD = 8                            # kPad: bf16 of padding a shared row
MAX_P, MAX_N = 128, 256
MAX_SMEM = 232448                  # 227 KB a block, H100
MAX_GRID_YZ = 65535                # heads and batch span grid.y and grid.z


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.arcadia_ssd_scan.argtypes = [p, p, p, p, p, p, p,
                                     i, i, i, i, i, i, i, i, p]
    lib.arcadia_ssd_scan.restype = ctypes.c_int


def _bind_tc(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.arcadia_ssd_scan_tc.argtypes = [p] * 10 + [i] * 7 + [
        ctypes.POINTER(ctypes.c_longlong), p]
    lib.arcadia_ssd_scan_tc.restype = ctypes.c_int
    lib.arcadia_ssd_scan_tc_plan.argtypes = [i, i, i,
                                             ctypes.POINTER(ctypes.c_longlong)]
    lib.arcadia_ssd_scan_tc_plan.restype = None


def tc_plan(P: int, N: int, Q: int) -> Tuple[int, int, int]:
    """The tensor-core route's plan (``arcadia_ssd_scan_tc_plan`` reports
    the same on the card): shared bytes of the chunk-state launch (cum
    fp64, warp sums, the fp32 token factors, two stages of 64-token x and
    B tiles), of the chunk-output launch (cum, dt, the C rows of a block,
    h_prev, two stages of B and x tiles), and the rows of a chunk-output
    block: 128 where Q and shared memory allow, else 64.  Shared rows are
    padded by 8 bf16."""
    def scan(rows: int) -> int:
        return (8 * Q + 4 * Q + 2 * (rows + P) * (N + PAD)
                + 2 * 2 * ROW_TILE * ((N + PAD) + (P + PAD)))
    state = 8 * Q + 8 * 16 + 4 * Q + 2 * 2 * ROW_TILE * ((P + PAD) + (N + PAD))
    rows = 2 * ROW_TILE if Q % (2 * ROW_TILE) == 0 and \
        scan(2 * ROW_TILE) <= MAX_SMEM else ROW_TILE
    return state, scan(rows), rows


def _strides(t: torch.Tensor) -> Tuple[int, int, int]:
    """(batch, token, head or group) element strides, 0 for a dimension
    of size 1 (it is never stepped)."""
    return tuple(0 if t.shape[k] == 1 else t.stride(k) for k in range(3))


def route(xh: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
          chunk: int) -> str:
    """The kernel that takes these inputs: a function of dtype, shape,
    strides and pointer alignment only (it runs on CPU tensors too)."""
    if xh.dtype != torch.bfloat16 or Bm.dtype != xh.dtype or \
            Cm.dtype != xh.dtype or xh.dim() != 4 or Bm.dim() != 4 or \
            Cm.dim() != 4:
        return "cuda_cores"
    B_, S, H, P = xh.shape
    N = Bm.shape[3]
    Q = min(chunk, S)
    if Q < 1 or P % 16 or P > MAX_P or N % 16 or N > MAX_N or \
            Q % ROW_TILE or S % Q or max(B_, H) > MAX_GRID_YZ:
        return "cuda_cores"
    if max(tc_plan(P, N, Q)[:2]) > MAX_SMEM:
        return "cuda_cores"
    for t in (xh, Bm, Cm):
        if t.stride(3) != 1 or t.data_ptr() % 16 or \
                any(s % 8 for s in _strides(t)):
            return "cuda_cores"
    return "tensor_cores"


def _check(xh, dt, A_log, Bm, Cm, chunk: int) -> int:
    if xh.device.type != "cuda":
        raise ValueError(f"SSD kernel needs CUDA tensors, got {xh.device}")
    for name, t in (("dt", dt), ("A_log", A_log), ("Bm", Bm), ("Cm", Cm)):
        if t.device != xh.device:
            raise ValueError(f"{name} is on {t.device}, xh on {xh.device}")
    for name, t in (("dt", dt), ("A_log", A_log)):
        if not t.is_contiguous():
            raise ValueError(f"SSD kernel needs a contiguous {name}")
    if xh.dtype not in _DTYPES:
        raise TypeError(f"SSD kernel takes fp32 or bf16 xh, got {xh.dtype}")
    if Bm.dtype != xh.dtype or Cm.dtype != xh.dtype:
        raise TypeError(f"Bm/Cm ({Bm.dtype}, {Cm.dtype}) must match xh "
                        f"({xh.dtype})")
    if dt.dtype != torch.float32 or A_log.dtype != torch.float32:
        raise TypeError(f"dt and A_log must be fp32, got {dt.dtype}, "
                        f"{A_log.dtype}")
    if xh.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"expected xh [B,S,H,P] and Bm [B,S,G,N], got "
                         f"{tuple(xh.shape)}, {tuple(Bm.shape)}")
    B_, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if tuple(dt.shape) != (B_, S, H) or tuple(A_log.shape) != (H,) or \
            tuple(Bm.shape[:2]) != (B_, S) or Cm.shape != Bm.shape:
        raise ValueError(f"SSD shapes disagree: xh {tuple(xh.shape)}, dt "
                         f"{tuple(dt.shape)}, A_log {tuple(A_log.shape)}, "
                         f"Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    Q = min(chunk, S)
    if Q < 1 or S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    if H % G:
        raise ValueError(f"{G} groups do not divide {H} heads")
    return Q


def ssd_cuda(xh: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan of CUDA tensors on the kernel that ``route`` picks: the
    contract of ``ref.ssd_reference`` -> (y [B,S,H,P] in xh's dtype,
    contiguous; state [B,H,P,N] fp32).  The tensor-core kernel reads xh,
    Bm and Cm through their strides; the CUDA-core kernel takes contiguous
    tensors, so its route copies views (fp32 mixer views, and bf16 views
    whose alignment the tensor cores cannot take)."""
    global LAUNCHES, TENSOR_CORE_LAUNCHES, CUDA_CORE_LAUNCHES
    Q = _check(xh, dt, A_log, Bm, Cm, chunk)
    kind = route(xh, Bm, Cm, Q)
    B_, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if kind == "cuda_cores":
        xh, Bm, Cm = xh.contiguous(), Bm.contiguous(), Cm.contiguous()
    y = torch.empty((B_, S, H, P), dtype=xh.dtype, device=xh.device)
    state = torch.empty((B_, H, P, N), dtype=torch.float32, device=xh.device)
    if y.numel() == 0:
        return y, state.zero_()
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "cuda_cores":
            lib = nvcc.load(SOURCE, _bind)
            err = lib.arcadia_ssd_scan(
                xh.data_ptr(), dt.data_ptr(), A_log.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
                B_, S, H, P, G, N, Q, _DTYPES[xh.dtype], stream)
        else:
            lib = nvcc.load(TC_SOURCE, _bind_tc)
            nc = S // Q
            chunk_state = torch.empty((B_, H, nc, P, N), dtype=torch.float32,
                                      device=xh.device)
            cum = torch.empty((B_, H, S), dtype=torch.float64,
                              device=xh.device)
            h_prev = torch.empty((B_, H, nc, P, N), dtype=torch.bfloat16,
                                 device=xh.device)
            strides = (ctypes.c_longlong * 9)(
                *_strides(xh), *_strides(Bm), *_strides(Cm))
            err = lib.arcadia_ssd_scan_tc(
                xh.data_ptr(), dt.data_ptr(), A_log.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
                chunk_state.data_ptr(), cum.data_ptr(), h_prev.data_ptr(),
                B_, S, H, P, G, N, Q, strides, stream)
    if err != 0:
        raise RuntimeError(f"SSD kernel launch failed ({kind}): cudaError_t "
                           f"{err} (B={B_}, S={S}, H={H}, P={P}, G={G}, "
                           f"N={N}, Q={Q}, {xh.dtype})")
    LAUNCHES += 1
    if kind == "tensor_cores":
        TENSOR_CORE_LAUNCHES += 1
    else:
        CUDA_CORE_LAUNCHES += 1
    return y, state


def tc_kernel_plan(P: int, N: int, Q: int) -> Tuple[int, int, int]:
    """``arcadia_ssd_scan_tc_plan`` of the built library: what the card's
    launches ask for (held to ``tc_plan`` by the card tests)."""
    lib = nvcc.load(TC_SOURCE, _bind_tc)
    out = (ctypes.c_longlong * 3)()
    lib.arcadia_ssd_scan_tc_plan(P, N, Q, out)
    return int(out[0]), int(out[1]), int(out[2])
