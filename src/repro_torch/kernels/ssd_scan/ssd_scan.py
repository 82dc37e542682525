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
  (P or N not a multiple of 16), chunks (not 64·k) or layouts (not 16-byte
  aligned): the same three launches with every chunk in parallel and the
  products on the tensor cores too (mma.sync; the route keeps its name).
  fp32 takes each product as three TF32 products, its operands split into
  hi and lo planes once as they are staged (``ref.ssd_split_reference`` is
  the CPU mirror); bf16 keeps the tensor-core route's roundings.  Operands
  land through a cp.async ring where the alignment allows and plain loads
  where it does not, with the same arithmetic; views are read through
  their strides, so the mixer's views go in without a copy (only a view
  whose last dimension is not contiguous is copied first).

See the notes at the top of the sources.  Each source is compiled with
``nvcc`` at first use and bound with ``ctypes`` (``kernels/nvcc.py``);
nothing is compiled at import time.

``LAUNCHES`` counts scan calls that launched, one per call whatever the
number of kernels; ``TENSOR_CORE_LAUNCHES`` and ``CUDA_CORE_LAUNCHES`` each
route's.  ``ssd_cuda`` adds one to ``LAUNCHES`` and to its route's count
right after each successful call and nowhere else.

The gradient (``ssd_backward_cuda``) has two routes too, chosen by
``backward_route`` from the same kind of facts (dy's among them):

* ``"tensor_cores"`` (``csrc/ssd_scan_bwd_tc.cu``) — bf16 xh, Bm, Cm and dy
  with P and N multiples of 16 (P <= 128, N <= 256), a chunk of 64·k,
  16-byte aligned pointers and strides of 8·k elements: seven launches
  (chunk sums, state passes, pairs, columns, group, finalize, dA_log) with
  every product on the tensor cores, C·Bᵀ once per group, dB and dC summed
  over a group's heads inside the kernel, the inputs read through their
  strides;
* ``"cuda_cores"`` (``csrc/ssd_scan_bwd.cu``) — fp32, and bf16 at other
  widths, chunks or layouts, P <= 128 and N <= 256: the same seven launches
  as the tensor-core gradient, every product on the tensor cores
  (mma.sync): fp32 as three TF32 products with h0 and G kept in fp32
  (``ref.ssd_backward_split_reference`` is the CPU mirror), bf16 with the
  tensor-core gradient's roundings; views read through their strides
  (one whose last dimension is not contiguous, such as autograd's
  expanded cotangent of ``y.sum()``, copied first).

Neither uses atomics, so two calls give the same bits.
``BACKWARD_LAUNCHES`` counts gradient calls that launched, one per call,
and ``BACKWARD_TENSOR_CORE_LAUNCHES`` / ``BACKWARD_CUDA_CORE_LAUNCHES``
each route's, added right after each successful call and nowhere else.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import nvcc

LAUNCHES = 0
TENSOR_CORE_LAUNCHES = 0
CUDA_CORE_LAUNCHES = 0
BACKWARD_LAUNCHES = 0
BACKWARD_TENSOR_CORE_LAUNCHES = 0
BACKWARD_CUDA_CORE_LAUNCHES = 0

SOURCE = nvcc.CSRC / "ssd_scan.cu"
TC_SOURCE = nvcc.CSRC / "ssd_scan_tc.cu"
BWD_SOURCE = nvcc.CSRC / "ssd_scan_bwd.cu"
BWD_TC_SOURCE = nvcc.CSRC / "ssd_scan_bwd_tc.cu"
# the backward's launches, in order, on either route (``bwd_kernel_info``,
# ``bwd_tc_kernel_info``)
BWD_LAUNCH_NAMES = (
    "chunk sums", "state passes", "pairs", "columns", "group", "finalize",
    "dA_log")
SLICE_P = 32                       # kSliceP of ssd_scan_bwd_tc.cu
# the CUDA-core scan's launches, in order (``kernel_info``)
LAUNCH_NAMES = ("chunk state", "state passing", "chunk output")
SLICE = 32                         # kSlice of ssd_scan.cu, ssd_scan_bwd.cu
STATE_ROWS = 64                    # kStateRows: head columns a chunk-sum block
STATE_BLOCK = 128                  # kStateBlock: its state columns
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROW_TILE = 64                      # kTile of ssd_scan_tc.cu
PAD = 8                            # kPad: bf16 of padding a shared row
MAX_P, MAX_N = 128, 256
MAX_SMEM = 232448                  # 227 KB a block, H100
MAX_GRID_YZ = 65535                # heads and batch span grid.y and grid.z


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.arcadia_ssd_scan.argtypes = [p] * 10 + [i] * 8 + [
        ctypes.POINTER(ctypes.c_longlong), p]
    lib.arcadia_ssd_scan.restype = ctypes.c_int
    lib.arcadia_ssd_scan_plan.argtypes = [i, i, i, i,
                                          ctypes.POINTER(ctypes.c_longlong)]
    lib.arcadia_ssd_scan_plan.restype = None
    lib.arcadia_ssd_scan_info.argtypes = [i, i, i,
                                          ctypes.POINTER(ctypes.c_int)]
    lib.arcadia_ssd_scan_info.restype = ctypes.c_int


def _bind_tc(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.arcadia_ssd_scan_tc.argtypes = [p] * 10 + [i] * 7 + [
        ctypes.POINTER(ctypes.c_longlong), p]
    lib.arcadia_ssd_scan_tc.restype = ctypes.c_int
    lib.arcadia_ssd_scan_tc_plan.argtypes = [i, i, i,
                                             ctypes.POINTER(ctypes.c_longlong)]
    lib.arcadia_ssd_scan_tc_plan.restype = None


def _bind_bwd(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.arcadia_ssd_scan_bwd.argtypes = [p] * 13 + [i] * 8 + [
        ctypes.POINTER(ctypes.c_longlong), p]
    lib.arcadia_ssd_scan_bwd.restype = ctypes.c_int
    lib.arcadia_ssd_scan_bwd_plan.argtypes = [
        i, i, i, i, ctypes.POINTER(ctypes.c_longlong)]
    lib.arcadia_ssd_scan_bwd_plan.restype = None
    lib.arcadia_ssd_scan_bwd_scratch_bytes.argtypes = [i] * 8
    lib.arcadia_ssd_scan_bwd_scratch_bytes.restype = ctypes.c_longlong
    lib.arcadia_ssd_scan_bwd_info.argtypes = [i, i, i, i,
                                              ctypes.POINTER(ctypes.c_int)]
    lib.arcadia_ssd_scan_bwd_info.restype = ctypes.c_int


def _bind_bwd_tc(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.arcadia_ssd_scan_bwd_tc.argtypes = [p] * 13 + [i] * 7 + [
        ctypes.POINTER(ctypes.c_longlong), p]
    lib.arcadia_ssd_scan_bwd_tc.restype = ctypes.c_int
    lib.arcadia_ssd_scan_bwd_tc_plan.argtypes = [
        i, i, i, ctypes.POINTER(ctypes.c_longlong)]
    lib.arcadia_ssd_scan_bwd_tc_plan.restype = None
    lib.arcadia_ssd_scan_bwd_tc_scratch_bytes.argtypes = [i] * 7
    lib.arcadia_ssd_scan_bwd_tc_scratch_bytes.restype = ctypes.c_longlong
    lib.arcadia_ssd_scan_bwd_tc_info.argtypes = [i, i, i,
                                                 ctypes.POINTER(ctypes.c_int)]
    lib.arcadia_ssd_scan_bwd_tc_info.restype = ctypes.c_int


def bwd_tc_plan(P: int, N: int, Q: int) -> Tuple[int, int, int, int, int]:
    """Shared bytes of the tensor-core backward's launches, as
    ``arcadia_ssd_scan_bwd_tc_plan`` reports them: chunk sums (cum, the
    factors, two stages of 64-token x/dy and B/C tiles), pairs (the B_J
    and C_I tiles of C·Bᵀ, two stages of a head's cum, dt, x_J and dy_I, the
    cross-warp row sums), columns (cum, x_J, two stages of a slice of G and
    B_J or of dy_I), group (C_T, the cross-warp u sums, two stages of a
    head's 32-row slice of x or dy and G or h0, or of W's hi and lo tiles
    and C_I or B_J) and finalize (da, the row minus column sums, v).
    Shared rows are padded by 8 bf16."""
    t, w = ROW_TILE, ROW_TILE + PAD
    sums = 8 * Q + 8 * 16 + 4 * Q + 2 * 2 * t * ((P + PAD) + (N + PAD))
    pair_stage = 2 * t * 8 + 4 * t + 2 * 2 * t * (P + PAD)
    pairs = 2 * 2 * t * (N + PAD) + 2 * pair_stage + 8 * 4 * t
    cols = 8 * Q + 2 * t * (P + PAD) + 2 * max(2 * (P + t) * w,
                                               2 * t * (P + PAD))
    head = 8 * t + 16 + 4 * t + 2 * t * (SLICE_P + PAD) + \
        2 * SLICE_P * (N + PAD)
    quad = 2 * 2 * t * w + 2 * t * (N + PAD)
    group = 2 * t * (N + PAD) + 8 * 2 * t + 2 * max(head, quad)
    return sums, pairs, cols, group, 24 * Q


def backward_route(xh: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                   dy: torch.Tensor, chunk: int) -> str:
    """The backward kernel that takes these inputs: a function of dtype,
    shape, strides and pointer alignment only (it runs on CPU tensors
    too).  "tensor_cores" for bf16 xh, Bm, Cm and dy with P and N multiples
    of 16 (P <= 128, N <= 256), a chunk of 64·k dividing the sequence, the
    four 16-byte aligned with strides of 8·k elements and the last
    dimension contiguous; else "cuda_cores"."""
    ts = (xh, Bm, Cm, dy)
    if any(t.dtype != torch.bfloat16 or t.dim() != 4 for t in ts):
        return "cuda_cores"
    B_, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    if Q < 1 or G < 1 or P % 16 or P > MAX_P or N % 16 or N > MAX_N or \
            Q % ROW_TILE or S % Q or H % G or \
            max(B_, H, B_ * G) > MAX_GRID_YZ:
        return "cuda_cores"
    if max(bwd_tc_plan(P, N, Q)) > MAX_SMEM:
        return "cuda_cores"
    for t in ts:
        if t.stride(3) != 1 or t.data_ptr() % 16 or \
                any(s % 8 for s in _strides(t)):
            return "cuda_cores"
    return "tensor_cores"


def bwd_plan(P: int, N: int, Q: int, dtype: torch.dtype
             ) -> Tuple[int, int, int, int, int]:
    """Shared bytes of the CUDA-core backward's launches, as
    ``arcadia_ssd_scan_bwd_plan`` reports them: chunk sums (cum, warp sums,
    the token factors, two landing stages of x or dy [32][64 p] and B or C
    [32][128 n], their planes), pairs (two stages of two [64][32] slices,
    their planes, the cross-warp row sums, a head's cum and dt), columns
    (cum, two stages of B_J [64][32] and G [P][32] fp32 or dy [32][P], their
    planes), group (a head's cum and dt, u's halves, two stages of a
    [64][32] fp32 slice and a [32][N] fp32 one, two A planes and the B
    planes) and finalize (da, the row minus column sums, v).  Planes: fp32
    as TF32 hi and lo (rows of 36 words), bf16 one plane (rows of 40)."""
    el, ld, planes = (4, SLICE + 4, 2) if dtype == torch.float32 else \
        (2, SLICE + 8, 1)
    t, sl = ROW_TILE, SLICE
    P16, N16, Qp = _ceil(P, 16), _ceil(N, 16), _ceil(Q, ROW_TILE)
    rb = max(t, P16)
    plane = lambda rows: rows * ld * el  # noqa: E731
    sums = (8 * Qp + 8 * 16 + 4 * Qp
            + 2 * (_landed(sl, STATE_ROWS, el) + _landed(sl, STATE_BLOCK, el))
            + plane(STATE_ROWS + STATE_BLOCK) * planes)
    pairs = (2 * 2 * _landed(t, sl, el) + 2 * plane(t) * planes + 8 * 4 * t
             + 8 * 2 * t + 4 * t)
    cols = (8 * Qp + 2 * (_landed(t, sl, el) + max(_landed(rb, sl, 4),
                                                   _landed(sl, P16, el)))
            + plane(t + rb) * planes)
    group = (8 * t + 16 + 4 * t + 8 * 2 * t
             + 2 * (max(_landed(t, sl, 4), _landed(sl, t, 4))
                    + _landed(sl, N16, 4))
             + 2 * plane(t) + plane(N16) * planes)
    return sums, pairs, cols, group, 24 * Q


def _ceil(v: int, m: int) -> int:
    return -(-v // m) * m


def _landed(rows: int, cols: int, el: int) -> int:
    """Bytes of a landed [rows][cols] tile of el-byte values, each row
    padded by 16 bytes (``raw_bytes`` of the sources)."""
    return rows * (cols + 16 // el) * el


def plan(P: int, N: int, Q: int, dtype: torch.dtype) -> Tuple[int, int]:
    """Shared bytes of the CUDA-core route's chunk-state and chunk-output
    launches (``arcadia_ssd_scan_plan`` reports the same on the card): cum
    fp64 over the chunk's 64-token tiles, the chunk-state launch's warp sums
    and token factors or the chunk-output launch's dt, two landing stages
    of a 32-deep slice as stored (x [32][64 p] and B [32][128 n]; C_I
    [64][32] and B_J, h_prev [P][32] or x [32][P]), and the slice split
    into its operand planes (fp32: TF32 hi and lo, rows of 36 words; bf16:
    one plane, rows of 40).  N is streamed in slices and does not enter."""
    del N
    el, ld, planes = (4, SLICE + 4, 2) if dtype == torch.float32 else \
        (2, SLICE + 8, 1)
    P16, Qp = _ceil(P, 16), _ceil(Q, ROW_TILE)
    rb = max(ROW_TILE, P16)
    rows = STATE_ROWS + STATE_BLOCK
    state = (8 * Qp + 8 * 16 + 4 * Qp
             + 2 * (_landed(SLICE, STATE_ROWS, el)
                    + _landed(SLICE, STATE_BLOCK, el))
             + rows * ld * el * planes)
    scan = (8 * Qp + 4 * Qp
            + 2 * (_landed(ROW_TILE, SLICE, el)
                   + max(_landed(rb, SLICE, el), _landed(SLICE, P16, el)))
            + (ROW_TILE + rb) * ld * el * planes)
    return state, scan


def kernel_plan(P: int, N: int, Q: int, dtype: torch.dtype
                ) -> Tuple[int, int]:
    """``arcadia_ssd_scan_plan`` of the built library (held to ``plan`` by
    the card tests)."""
    lib = nvcc.load(SOURCE, _bind)
    out = (ctypes.c_longlong * 2)()
    lib.arcadia_ssd_scan_plan(P, N, Q, _DTYPES[dtype], out)
    return int(out[0]), int(out[1])


def kernel_info(P: int, dtype: torch.dtype) -> list:
    """``cudaFuncGetAttributes`` of each launch's kernel of the CUDA-core
    scan at head dim P: a dict per launch (``LAUNCH_NAMES`` order) with
    registers a thread, local (spill) bytes, static shared bytes and max
    threads a block."""
    return _info(nvcc.load(SOURCE, _bind).arcadia_ssd_scan_info, LAUNCH_NAMES,
                 (P, _DTYPES[dtype]))


def _info(fn, names, args) -> list:
    out = []
    for k, name in enumerate(names):
        vals = (ctypes.c_int * 4)()
        err = fn(k, *args, vals)
        if err != 0:
            raise RuntimeError(f"cudaFuncGetAttributes failed ({err}) for "
                               f"the {name} launch")
        out.append(dict(launch=name, registers=vals[0], local_bytes=vals[1],
                        static_shared_bytes=vals[2], max_threads=vals[3]))
    return out


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


def _readable(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the CUDA-core kernels read it: through its batch, token and
    head or group strides, with the last dimension contiguous.  A view whose
    last dimension is not (a transpose, or autograd's expanded cotangent of
    a ``sum()``) is copied; any other goes in as it is."""
    return t if t.shape[3] == 1 or t.stride(3) == 1 else t.contiguous()


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
    contiguous; state [B,H,P,N] fp32).  Both routes read xh, Bm and Cm
    through their strides (the CUDA-core route copies a view whose last
    dimension is not contiguous; the tensor-core route never gets one) and
    take their intermediates from ``torch.empty``: S_c [B,H,S/Q,P,N] fp32, cum
    [B,H,S] fp64, h_prev [B,H,S/Q,P,N] (bf16 on the tensor-core route, the
    inputs' dtype on the CUDA-core one)."""
    global LAUNCHES, TENSOR_CORE_LAUNCHES, CUDA_CORE_LAUNCHES
    Q = _check(xh, dt, A_log, Bm, Cm, chunk)
    kind = route(xh, Bm, Cm, Q)
    B_, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if kind == "cuda_cores":
        xh, Bm, Cm = (_readable(t) for t in (xh, Bm, Cm))
        if P > MAX_P or max(B_, H) > MAX_GRID_YZ or \
                max(plan(P, N, Q, xh.dtype)) > MAX_SMEM:
            raise ValueError(f"SSD kernel takes P <= {MAX_P} within "
                             f"{MAX_SMEM} shared bytes: P={P}, Q={Q}")
    y = torch.empty((B_, S, H, P), dtype=xh.dtype, device=xh.device)
    state = torch.empty((B_, H, P, N), dtype=torch.float32, device=xh.device)
    if y.numel() == 0:
        return y, state.zero_()
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream().cuda_stream
        nc = S // Q
        chunk_state = torch.empty((B_, H, nc, P, N), dtype=torch.float32,
                                  device=xh.device)
        cum = torch.empty((B_, H, S), dtype=torch.float64, device=xh.device)
        strides = (ctypes.c_longlong * 9)(
            *_strides(xh), *_strides(Bm), *_strides(Cm))
        if kind == "cuda_cores":
            lib = nvcc.load(SOURCE, _bind)
            h_prev = torch.empty((B_, H, nc, P, N), dtype=xh.dtype,
                                 device=xh.device)
            err = lib.arcadia_ssd_scan(
                xh.data_ptr(), dt.data_ptr(), A_log.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
                chunk_state.data_ptr(), cum.data_ptr(), h_prev.data_ptr(),
                B_, S, H, P, G, N, Q, _DTYPES[xh.dtype], strides, stream)
        else:
            lib = nvcc.load(TC_SOURCE, _bind_tc)
            h_prev = torch.empty((B_, H, nc, P, N), dtype=torch.bfloat16,
                                 device=xh.device)
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


def ssd_backward_cuda(xh: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                      Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor,
                      dstate, chunk: int) -> Tuple[torch.Tensor, ...]:
    """The gradient of the scan of CUDA tensors (the contract of
    ``ref.ssd_backward_reference``) on the kernel that ``backward_route``
    picks: dy [B,S,H,P] in xh's dtype and an optional d(final state)
    [B,H,P,N] -> (dxh, ddt, dA_log, dBm, dCm), each in its input's dtype,
    contiguous.  Both kernels read xh, Bm, Cm and dy through their strides
    (the CUDA-core route copies a view whose last dimension is not
    contiguous, as ``_readable`` says) and take one scratch buffer the
    size their library reports."""
    global BACKWARD_LAUNCHES, BACKWARD_TENSOR_CORE_LAUNCHES, \
        BACKWARD_CUDA_CORE_LAUNCHES
    Q = _check(xh, dt, A_log, Bm, Cm, chunk)
    B_, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if dy.shape != xh.shape or dy.dtype != xh.dtype or dy.device != xh.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} on {dy.device} must "
                         f"match xh {tuple(xh.shape)} {xh.dtype} on {xh.device}")
    if dstate is not None and (tuple(dstate.shape) != (B_, H, P, N) or
                               dstate.device != xh.device):
        raise ValueError(f"d(state) {tuple(dstate.shape)} on {dstate.device} "
                         f"must be [B,H,P,N] = {(B_, H, P, N)} on {xh.device}")
    if backward_route(xh, Bm, Cm, dy, Q) == "tensor_cores":
        grads = _backward_tensor_cores(xh, dt, A_log, Bm, Cm, dy, dstate, Q)
        BACKWARD_LAUNCHES += 1
        BACKWARD_TENSOR_CORE_LAUNCHES += 1
        return grads
    if P > MAX_P or N > MAX_N or max(B_, H) > MAX_GRID_YZ or \
            max(bwd_plan(P, N, Q, xh.dtype)) > MAX_SMEM:
        raise ValueError(f"SSD backward takes P <= {MAX_P}, N <= {MAX_N} "
                         f"within {MAX_SMEM} shared bytes: P={P}, N={N}, Q={Q}")
    xh, Bm, Cm, dy = (_readable(t) for t in (xh, Bm, Cm, dy))
    if dstate is not None:
        dstate = dstate.float().contiguous()
    dev = xh.device
    dxh = torch.empty((B_, S, H, P), dtype=xh.dtype, device=dev)
    ddt = torch.empty((B_, S, H), dtype=torch.float32, device=dev)
    dA_log = torch.empty((H,), dtype=torch.float32, device=dev)
    dBm = torch.empty((B_, S, G, N), dtype=Bm.dtype, device=dev)
    dCm = torch.empty_like(dBm)
    if xh.numel() == 0:
        return dxh, ddt.zero_(), dA_log.zero_(), dBm.zero_(), dCm.zero_()
    with torch.cuda.device(dev):
        lib = nvcc.load(BWD_SOURCE, _bind_bwd)
        n_scratch = lib.arcadia_ssd_scan_bwd_scratch_bytes(
            B_, S, H, P, G, N, Q, _DTYPES[xh.dtype])
        if n_scratch < 0:
            raise ValueError(f"SSD backward refuses B={B_}, S={S}, H={H}, "
                             f"P={P}, G={G}, N={N}, Q={Q}")
        scratch = torch.empty((n_scratch,), dtype=torch.uint8, device=dev)
        strides = (ctypes.c_longlong * 12)(
            *_strides(xh), *_strides(Bm), *_strides(Cm), *_strides(dy))
        err = lib.arcadia_ssd_scan_bwd(
            *(None if t is None else t.data_ptr() for t in (
                xh, dt, A_log, Bm, Cm, dy, dstate, dxh, ddt, dA_log, dBm,
                dCm, scratch)),
            B_, S, H, P, G, N, Q, _DTYPES[xh.dtype], strides,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"SSD backward kernel launch failed: cudaError_t "
                           f"{err} (B={B_}, S={S}, H={H}, P={P}, G={G}, N={N}, "
                           f"Q={Q}, {xh.dtype})")
    BACKWARD_LAUNCHES += 1
    BACKWARD_CUDA_CORE_LAUNCHES += 1
    return dxh, ddt, dA_log, dBm, dCm


def _backward_tensor_cores(xh, dt, A_log, Bm, Cm, dy, dstate, Q: int
                           ) -> Tuple[torch.Tensor, ...]:
    """One call of ``arcadia_ssd_scan_bwd_tc`` on the inputs as they are
    (strided views included); scratch and outputs from ``torch.empty``.
    Raises if the library does not build or the launch fails."""
    B_, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    dev = xh.device
    if dstate is not None:
        dstate = dstate.float().contiguous()
    dxh = torch.empty((B_, S, H, P), dtype=torch.bfloat16, device=dev)
    ddt = torch.empty((B_, S, H), dtype=torch.float32, device=dev)
    dA_log = torch.empty((H,), dtype=torch.float32, device=dev)
    dBm = torch.empty((B_, S, G, N), dtype=torch.bfloat16, device=dev)
    dCm = torch.empty_like(dBm)
    if xh.numel() == 0:
        return dxh, ddt.zero_(), dA_log.zero_(), dBm.zero_(), dCm.zero_()
    with torch.cuda.device(dev):
        lib = nvcc.load(BWD_TC_SOURCE, _bind_bwd_tc)
        n_scratch = lib.arcadia_ssd_scan_bwd_tc_scratch_bytes(
            B_, S, H, P, G, N, Q)
        if n_scratch < 0:
            raise ValueError(f"SSD tensor-core backward refuses B={B_}, "
                             f"S={S}, H={H}, P={P}, G={G}, N={N}, Q={Q}")
        scratch = torch.empty((n_scratch,), dtype=torch.uint8, device=dev)
        strides = (ctypes.c_longlong * 12)(
            *_strides(xh), *_strides(Bm), *_strides(Cm), *_strides(dy))
        err = lib.arcadia_ssd_scan_bwd_tc(
            *(None if t is None else t.data_ptr() for t in (
                xh, dt, A_log, Bm, Cm, dy, dstate, dxh, ddt, dA_log, dBm,
                dCm, scratch)),
            B_, S, H, P, G, N, Q, strides,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"SSD backward kernel launch failed "
                           f"(tensor_cores): cudaError_t {err} (B={B_}, "
                           f"S={S}, H={H}, P={P}, G={G}, N={N}, Q={Q})")
    return dxh, ddt, dA_log, dBm, dCm


def bwd_tc_kernel_plan(P: int, N: int, Q: int) -> Tuple[int, ...]:
    """``arcadia_ssd_scan_bwd_tc_plan`` of the built library (held to
    ``bwd_tc_plan`` by the card tests)."""
    lib = nvcc.load(BWD_TC_SOURCE, _bind_bwd_tc)
    out = (ctypes.c_longlong * 5)()
    lib.arcadia_ssd_scan_bwd_tc_plan(P, N, Q, out)
    return tuple(int(v) for v in out)


def bwd_tc_kernel_info(P: int, N: int) -> list:
    """``cudaFuncGetAttributes`` of each launch's kernel of the tensor-core
    backward at head dim P and state dim N: a dict per launch (in
    ``BWD_LAUNCH_NAMES`` order) with registers a thread, local (spill)
    bytes, static shared bytes and max threads a block."""
    return _info(nvcc.load(BWD_TC_SOURCE, _bind_bwd_tc)
                 .arcadia_ssd_scan_bwd_tc_info, BWD_LAUNCH_NAMES, (P, N))


def bwd_kernel_plan(P: int, N: int, Q: int, dtype: torch.dtype
                    ) -> Tuple[int, ...]:
    """``arcadia_ssd_scan_bwd_plan`` of the built library (held to
    ``bwd_plan`` by the card tests)."""
    lib = nvcc.load(BWD_SOURCE, _bind_bwd)
    out = (ctypes.c_longlong * 5)()
    lib.arcadia_ssd_scan_bwd_plan(P, N, Q, _DTYPES[dtype], out)
    return tuple(int(v) for v in out)


def bwd_kernel_info(P: int, N: int, dtype: torch.dtype) -> list:
    """``cudaFuncGetAttributes`` of each launch's kernel of the CUDA-core
    backward at head dim P and state dim N: a dict per launch (in
    ``BWD_LAUNCH_NAMES`` order) with registers a thread, local (spill)
    bytes, static shared bytes and max threads a block."""
    return _info(nvcc.load(BWD_SOURCE, _bind_bwd).arcadia_ssd_scan_bwd_info,
                 BWD_LAUNCH_NAMES, (P, N, _DTYPES[dtype]))


def tc_kernel_plan(P: int, N: int, Q: int) -> Tuple[int, int, int]:
    """``arcadia_ssd_scan_tc_plan`` of the built library: what the card's
    launches ask for (held to ``tc_plan`` by the card tests)."""
    lib = nvcc.load(TC_SOURCE, _bind_tc)
    out = (ctypes.c_longlong * 3)()
    lib.arcadia_ssd_scan_tc_plan(P, N, Q, out)
    return int(out[0]), int(out[1]), int(out[2])
