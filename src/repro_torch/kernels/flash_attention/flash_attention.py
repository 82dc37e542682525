"""CUDA kernels of flash attention, forward and backward: bind and launch.

The kernels (``csrc/flash_attention.cu``) replace the JAX package's Pallas
TPU kernel ``_flash_kernel`` (``repro/kernels/flash_attention/
flash_attention.py``).  Two routes, chosen by dtype, head dims and
alignment inside ``arcadia_flash_attention`` (see the note at the top of
the source):

* ``"tensor_cores"`` — bf16 at the (q/k head dim D, v head dim Dv) pairs
  of ``TENSOR_CORE_PAIRS``: (64, 64), (80, 80) (hubert-xlarge), (128,
  128), (192, 128) (MLA's prefill) and (256, 256), with 16-byte aligned
  pointers and strides (TMA's rule): both products on wgmma, K/V tiles
  brought by TMA into a two-stage ring by a producer warpgroup, 128 query
  rows a block;
* ``"cuda_cores"`` — fp32, bf16 at other pairs, and bf16 views whose
  pointers or strides are not 16-byte aligned (the name its launch
  counters keep; its kernel, ``flash_fwd_kernel``, runs on the tensor
  cores through ``mma.sync``): fp32 inputs as three TF32 products a
  product (hi = tf32(x), lo = tf32(x - hi); ``ref.attention_split_
  reference`` mirrors it), bf16 inputs as bf16 products with fp32 sums,
  K/V tiles in a two-stage ``cp.async`` ring, 128 query rows a block.

The source is compiled with ``nvcc`` at first use and bound with
``ctypes`` (``kernels/nvcc.py``); nothing is compiled at import time.

``LAUNCHES`` counts the launches of both kernels, ``TENSOR_CORE_LAUNCHES``
and ``CUDA_CORE_LAUNCHES`` each route's: ``flash_attention_cuda`` adds one
to ``LAUNCHES`` and to the count of the route the C side reports, right
after each successful launch, and nowhere else.  Asked for it
(``return_lse=True``, training), the forward also writes each row's
log-sum-exp.

The backward (``flash_attention_backward_cuda``) has two routes, chosen by
``backward_route`` from dtype, head dims and alignment before any launch,
three launches a call each (delta = rowsum(dO ∘ O); dK and dV per kv head
and key tile, the group's heads summed in order; dQ per head and query
tile), no atomics:

* ``"tensor_cores"`` (``csrc/flash_attention_bwd_tc.cu``) — bf16 at the
  pairs of ``TENSOR_CORE_PAIRS`` with q, k, v and o 16-byte aligned
  (pointers and strides): every product on wgmma (bf16 operands, fp32
  sums), dS rounded to bf16 where it meets Q and K
  (``ref.attention_backward_tc_reference`` mirrors that rounding);
* ``"cuda_cores"`` (``csrc/flash_attention_bwd.cu``) — fp32, bf16 at other
  pairs and bf16 views that are not 16-byte aligned: ``mma.sync`` on the
  tensor cores, fp32 S, dV, dK and dQ as TF32 splits and dP = dO·Vᵀ in
  fp32 FMAs (``ref.attention_backward_split_reference`` mirrors them),
  bf16 products with fp32 sums and dS as bf16 hi + lo where it meets Q
  and K; two-stage ``cp.async`` rings of Q/dO (dK/dV launch) and K/V (dQ
  launch).

``BACKWARD_LAUNCHES`` counts its calls, ``BACKWARD_TENSOR_CORE_LAUNCHES``
and ``BACKWARD_CUDA_CORE_LAUNCHES`` each route's calls,
``BACKWARD_CALL_LAUNCHES`` the kernels they launched (three each),
``BACKWARD_DO_COPIES`` the cotangents it had to copy (a dO the route cannot
read in place: for the CUDA cores a head dim that is not contiguous or
strides that are not multiples of 4 elements; for the tensor cores, TMA's
16-byte rule).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional

import torch

from .. import nvcc

LAUNCHES = 0
TENSOR_CORE_LAUNCHES = 0
CUDA_CORE_LAUNCHES = 0
BACKWARD_LAUNCHES = 0
BACKWARD_TENSOR_CORE_LAUNCHES = 0
BACKWARD_CUDA_CORE_LAUNCHES = 0
BACKWARD_CALL_LAUNCHES = 0
BACKWARD_DO_COPIES = 0

SOURCE = nvcc.CSRC / "flash_attention.cu"
BWD_SOURCE = nvcc.CSRC / "flash_attention_bwd.cu"
BWD_TC_SOURCE = nvcc.CSRC / "flash_attention_bwd_tc.cu"
BWD_KERNELS = ("delta", "dkdv", "dq")     # the three launches of a call
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_SMEM = 232448                          # 227 KB a block, H100
ROUTES = ("cuda_cores", "tensor_cores")    # the C side's route numbers
# (D, Dv) pairs with a flash_fwd_wgmma instantiation
TENSOR_CORE_PAIRS = ((64, 64), (80, 80), (128, 128), (192, 128), (256, 256))


@dataclass(frozen=True)
class TilePlan:
    """How the kernel serving a (dtype, head dim) tiles its work."""
    route: str
    rows: int            # query rows of a block
    keys: int            # keys of a K/V tile
    stages: int          # K/V tiles in flight
    smem_bytes: int      # dynamic shared memory of a launch


def tile_plan(dtype: torch.dtype, head_dim: int,
              v_head_dim: Optional[int] = None) -> TilePlan:
    """The plan of ``csrc/flash_attention.cu`` for inputs whose pointers
    and strides are 16-byte aligned (``arcadia_flash_kernel_info`` reports
    the same on the card), v's head dim ``v_head_dim`` (D unless given).
    Tensor cores (bf16 at a pair of ``TENSOR_CORE_PAIRS``): Q [128, D] plus
    two stages of K [Bc, D] and V [Bc, Dv] in bf16, each row a whole number
    of 64-column boxes of 128 bytes (D = 80 fills two, the columns past 80
    zero), 1 KB to align them to the swizzle and 128 B of mbarriers.
    ``"cuda_cores"`` (mma.sync): Q [128][ld(D)] plus two stages of K
    [Bc][ld(D)] and V [Bc][ld(Dv)] in the inputs' dtype, rows padded to 8k
    + 4 floats or 16k + 8 bf16 (``_mma_ld``), Bc = ``_mma_keys``."""
    dv = head_dim if v_head_dim is None else v_head_dim
    if dtype == torch.bfloat16 and (head_dim, dv) in TENSOR_CORE_PAIRS:
        keys = 64 if head_dim == 256 else 128
        boxes, v_boxes = -(-head_dim // 64), -(-dv // 64)
        smem = 1024 + 128 * boxes * 128 + 2 * keys * (boxes + v_boxes) * 128 \
            + 128
        return TilePlan("tensor_cores", 128, keys, 2, smem)
    tf32 = dtype == torch.float32
    keys = _mma_keys(tf32, _mma_width(head_dim))
    smem = (4 if tf32 else 2) * (128 * _mma_ld(head_dim, tf32) + 2 * keys * (
        _mma_ld(head_dim, tf32) + _mma_ld(dv, tf32)))
    return TilePlan("cuda_cores", 128, keys, 2, smem)


def _mma_width(head_dim: int) -> int:
    """The mma.sync kernels' instantiation: D rounded up to 64, 128, 192 or
    256 (the accumulators' width)."""
    return next(d for d in (64, 128, 192, 256) if head_dim <= d)


def _mma_keys(tf32: bool, width: int) -> int:
    """Keys of the forward's K/V tile: two stages beside 128 rows of Q fit
    227 KB at D = width."""
    if not tf32:
        return 64
    return 64 if width <= 128 else 32 if width == 192 else 16


def _mma_ld(n: int, tf32: bool) -> int:
    """Elements of a staged row of n columns: 8k + 4 floats, 16k + 8 bf16
    (fragment loads and ldmatrix free of bank conflicts)."""
    return -(-n // 8) * 8 + 4 if tf32 else -(-n // 16) * 16 + 8


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.arcadia_flash_attention.argtypes = [
        p, p, p, p, *[ll] * 12, p, ll, ll, i, i, i, i, i, i, i, i, f, f, i,
        p, ctypes.POINTER(i)]
    lib.arcadia_flash_attention.restype = ctypes.c_int
    lib.arcadia_flash_kernel_info.argtypes = [i, i, i, i, i,
                                              ctypes.POINTER(i)]
    lib.arcadia_flash_kernel_info.restype = ctypes.c_int


def kernel_info(dtype: torch.dtype, head_dim: int, capped: bool = False,
                v_head_dim: Optional[int] = None,
                route: Optional[str] = None) -> dict:
    """The plan and ``cudaFuncGetAttributes`` of the kernel that serves
    (dtype, head dim, v head dim (D unless given), with or without a
    softcap) on the card, for 16-byte aligned inputs or (``route=
    "cuda_cores"``) for inputs TMA cannot read: route, rows, keys, stages,
    smem_bytes, registers, local_bytes (spills), static_smem_bytes,
    max_threads."""
    dv = head_dim if v_head_dim is None else v_head_dim
    if route not in (None, *ROUTES):
        raise ValueError(f"no flash route {route!r}")
    lib = nvcc.load(SOURCE, _bind)
    out = (ctypes.c_int * 9)()
    err = lib.arcadia_flash_kernel_info(_DTYPES[dtype], int(head_dim),
                                        int(dv), int(capped),
                                        int(route == "cuda_cores"), out)
    if err != 0:
        raise RuntimeError(f"flash kernel info failed: cudaError_t {err} "
                           f"({dtype}, D={head_dim}, Dv={dv})")
    return dict(route=ROUTES[out[0]], rows=out[1], keys=out[2],
                stages=out[3], smem_bytes=out[4], registers=out[5],
                local_bytes=out[6], static_smem_bytes=out[7],
                max_threads=out[8])


@dataclass(frozen=True)
class BackwardPlan:
    """How the backward kernels serving a (dtype, D, Dv) tile their work."""
    route: str
    rows: int            # query rows of a dK/dV step
    keys: int            # keys of a dK/dV block
    smem_bytes: int      # dynamic shared memory of the dK/dV launch
    launches: int        # kernels a call
    dq_rows: int         # query rows of a dQ block
    dq_keys: int         # keys of a dQ step
    dq_smem_bytes: int   # dynamic shared memory of the dQ launch
    dq_stages: int       # K/V tiles in flight in the dQ launch


def _tc_pair(dtype: torch.dtype, head_dim: int, v_head_dim: int) -> bool:
    return dtype == torch.bfloat16 and (head_dim, v_head_dim) in \
        TENSOR_CORE_PAIRS


def backward_plan(dtype: torch.dtype, head_dim: int,
                  v_head_dim: Optional[int] = None,
                  route: Optional[str] = None) -> BackwardPlan:
    """The plan of the backward route that serves (dtype, D, Dv (D unless
    given)) for 16-byte aligned inputs, or of ``route`` where given
    (``arcadia_flash_bwd_kernel_info`` / ``arcadia_flash_bwd_tc_kernel_info``
    report the same on the card).

    Tensor cores (bf16 at a pair of ``TENSOR_CORE_PAIRS``): bf16 tiles of
    64-column boxes of 128 bytes (D = 80 fills two), 1 KB to align them to
    the swizzle and 128 B of mbarriers; dK/dV: K and V tiles of 64 keys
    plus two stages of Q and dO tiles of 64 queries; dQ: Q and dO of 128
    rows plus two stages of K and V tiles of 64 keys, one where two do not
    fit in 227 KB (D = 256).  ``"cuda_cores"`` (mma.sync, tiles in the
    inputs' dtype, rows of ``_mma_ld`` elements, width DM = D rounded up to
    64, 128, 192 or 256): dK/dV: K [Bk][ld(D)], V [Bk][ld(Dv)], two stages
    of Q [Bq][ld(D)], dO [Bq][ld(Dv)], lse and delta [Bq], P and dS
    [Bq][Bk + pad] (bf16: P, dS hi, dS lo); dQ: Q, dO, lse and delta of Bq
    rows, two stages of K and V [Bk], dSᵀ [Bk][Bq + pad] (bf16: hi, lo).
    (Bk, Bq) of dK/dV and (Bq, Bk) of dQ: fp32 (64, 64) and (64, 64) at
    DM 64, (64, 32) and (64, 64) at 128, (64, 32) and (64, 32) at 192,
    (32, 32) and (32, 32) at 256; bf16 (64, 64) and (64, 64)."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash backward takes fp32 or bf16, got {dtype}")
    dv = head_dim if v_head_dim is None else v_head_dim
    if not (0 < dv <= head_dim <= MAX_HEAD_DIM):
        raise ValueError(f"head dims ({head_dim}, {dv}) not taken")
    tc = _tc_pair(dtype, head_dim, dv)
    route = route or ("tensor_cores" if tc else "cuda_cores")
    if route not in ROUTES or (route == "tensor_cores" and not tc):
        raise ValueError(f"no {route} backward for {dtype} ({head_dim}, {dv})")
    if route == "tensor_cores":
        k_tile = -(-head_dim // 64) * 64 * 128       # a [64, D] tile's bytes
        v_tile = -(-dv // 64) * 64 * 128
        dkdv = 1024 + 3 * (k_tile + v_tile) + 128
        stages = 2 if 1024 + 4 * (k_tile + v_tile) + 128 <= MAX_SMEM else 1
        dq = 1024 + (2 + stages) * (k_tile + v_tile) + 128
        return BackwardPlan(route, 64, 64, dkdv, len(BWD_KERNELS), 128, 64,
                            dq, stages)
    tf32 = dtype == torch.float32
    dm = _mma_width(head_dim)
    es, pad = (4, 4) if tf32 else (2, 8)
    ld = _mma_ld(head_dim, tf32) + _mma_ld(dv, tf32)
    keys = 32 if tf32 and dm == 256 else 64
    rows = 64 if not tf32 or dm == 64 else 32
    dq_rows = 32 if tf32 and dm == 256 else 64
    dq_keys = 32 if tf32 and dm >= 192 else 64
    dkdv = es * ((keys + 2 * rows) * ld + (2 if tf32 else 3) * rows
                 * (keys + pad)) + 16 * rows
    dq = es * ((dq_rows + 2 * dq_keys) * ld + (1 if tf32 else 2) * dq_keys
               * (dq_rows + pad)) + 8 * dq_rows
    return BackwardPlan(route, rows, keys, dkdv, len(BWD_KERNELS), dq_rows,
                        dq_keys, dq, 2)


def backward_executed_ops(dtype: torch.dtype, head_dim: int,
                          v_head_dim: Optional[int] = None,
                          route: Optional[str] = None) -> int:
    """Operations the backward route serving (dtype, D, Dv), or ``route``,
    executes per attended (query, key) pair, where the function needs
    2·(3D + 2Dv).
    Tensor cores: Sᵀ twice, dPᵀ, dV and dK in the dK/dV launch and S, dP
    and dQ in the dQ launch, with dV's, dK's and dQ's widths rounded up to
    64-column boxes (D', Dv'): 2·(3D + 2Dv + Dv' + 2D').  CUDA cores
    (mma.sync), with D and Dv rounded up to the product's step (D', Dv': 8
    in fp32, 16 in bf16): S and dP in both launches, dV, dK and dQ; in fp32
    each product three TF32 products, 3·2·(4D' + 3Dv'); in bf16 dK and dQ
    twice (dS as hi + lo), 2·(6D' + 3Dv')."""
    dv = head_dim if v_head_dim is None else v_head_dim
    plan = backward_plan(dtype, head_dim, dv, route)
    if plan.route == "tensor_cores":
        wide, wide_v = -(-head_dim // 64) * 64, -(-dv // 64) * 64
        return 2 * (3 * head_dim + 2 * dv + wide_v + 2 * wide)
    step = 8 if dtype == torch.float32 else 16
    d, v = -(-head_dim // step) * step, -(-dv // step) * step
    if dtype == torch.float32:
        return 3 * 2 * (4 * d + 3 * v)
    return 2 * (6 * d + 3 * v)


def _bind_bwd(lib: ctypes.CDLL) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.arcadia_flash_attention_backward.argtypes = [
        *[p] * 10, *[ll] * 26, i, i, i, i, i, i, i, i, f, f, i, p]
    lib.arcadia_flash_attention_backward.restype = ctypes.c_int
    lib.arcadia_flash_bwd_kernel_info.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.arcadia_flash_bwd_kernel_info.restype = ctypes.c_int


def _bind_bwd_tc(lib: ctypes.CDLL) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.arcadia_flash_attention_backward_tc.argtypes = [
        *[p] * 10, *[ll] * 26, i, i, i, i, i, i, i, i, f, f, p]
    lib.arcadia_flash_attention_backward_tc.restype = ctypes.c_int
    lib.arcadia_flash_bwd_tc_kernel_info.argtypes = [i, i, ctypes.POINTER(i)]
    lib.arcadia_flash_bwd_tc_kernel_info.restype = ctypes.c_int


def backward_kernel_info(dtype: torch.dtype, head_dim: int,
                         v_head_dim: Optional[int] = None,
                         route: Optional[str] = None) -> dict:
    """The plan and ``cudaFuncGetAttributes`` of the backward kernels of
    the route that serves (dtype, D, Dv (D unless given)), or of ``route``,
    on the card: the fields of ``BackwardPlan`` (as the card reports them)
    and the registers and local (spill) bytes of each of ``BWD_KERNELS``
    (on the tensor cores the larger of the instantiations with and without
    a softcap)."""
    dv = head_dim if v_head_dim is None else v_head_dim
    plan = backward_plan(dtype, head_dim, dv, route)
    if plan.route == "tensor_cores":
        lib = nvcc.load(BWD_TC_SOURCE, _bind_bwd_tc)
        out = (ctypes.c_int * 12)()
        err = lib.arcadia_flash_bwd_tc_kernel_info(int(head_dim), int(dv), out)
        fields = dict(rows=out[0], keys=out[1], smem_bytes=out[2],
                      dq_rows=out[3], dq_keys=out[1], dq_smem_bytes=out[4],
                      dq_stages=out[5])
        regs = out[6:12]
    else:
        lib = nvcc.load(BWD_SOURCE, _bind_bwd)
        out = (ctypes.c_int * 12)()
        err = lib.arcadia_flash_bwd_kernel_info(_DTYPES[dtype], int(head_dim),
                                                int(dv), out)
        fields = dict(rows=out[0], keys=out[1], smem_bytes=out[2],
                      dq_rows=out[3], dq_keys=out[4], dq_smem_bytes=out[5],
                      dq_stages=2)
        regs = out[6:12]
    if err != 0:
        raise RuntimeError(f"flash backward kernel info failed: cudaError_t "
                           f"{err} ({dtype}, D={head_dim}, Dv={dv}, "
                           f"{plan.route})")
    return dict(route=plan.route, launches=len(BWD_KERNELS), **fields,
                registers={n: regs[2 * j] for j, n in enumerate(BWD_KERNELS)},
                local_bytes={n: regs[2 * j + 1]
                             for j, n in enumerate(BWD_KERNELS)})


def _tma_aligned(t: torch.Tensor) -> bool:
    """Head dim contiguous, data pointer and the other strides 16-byte
    aligned: what TMA reads."""
    return t.stride(-1) == 1 and not any(s % 8 for s in t.stride()[:3]) \
        and not t.data_ptr() % 16


def backward_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, do: torch.Tensor) -> str:
    """The backward kernels that take these inputs: a function of dtype,
    shape, strides and pointer alignment only (it runs on CPU tensors too).
    "tensor_cores" for bf16 q, k, v, o and do at a (D, Dv) pair of
    ``TENSOR_CORE_PAIRS`` with q, k, v and o 16-byte aligned (pointers and
    strides, TMA's rule, the head dim contiguous); else "cuda_cores".  A
    ``do`` that TMA cannot read is copied once by the caller, so its own
    alignment does not choose the route."""
    ts = (q, k, v, o, do)
    if any(t.dtype != torch.bfloat16 or t.dim() != 4 for t in ts):
        return "cuda_cores"
    if not _tc_pair(q.dtype, q.shape[-1], v.shape[-1]):
        return "cuda_cores"
    if not all(_tma_aligned(t) for t in (q, k, v, o)):
        return "cuda_cores"
    return "tensor_cores"


def _aligned(t: torch.Tensor) -> bool:
    """Head dim contiguous, strides and data pointer multiples of 4
    elements: what the kernels' vector reads need."""
    return t.stride(-1) == 1 and not any(s % 4 for s in t.stride()[:3]) \
        and not t.data_ptr() % (4 * t.element_size())


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless the kernel takes q [B,H,S,D], k [B,KV,S,D] and v
    [B,KV,S,Dv] as they are: CUDA tensors of one dtype (fp32 or bf16), KV
    dividing H, D <= 256 and Dv <= D, both multiples of 4, the head dim
    contiguous, and every stride and data pointer a multiple of four
    elements."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash kernel needs CUDA tensors, {name} is on "
                             f"{t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"flash kernel takes fp32 or bf16, {name} is "
                            f"{t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
        if not _aligned(t):
            raise ValueError(f"flash kernel needs {name} with a contiguous "
                             f"head dim and strides and data aligned to 4 "
                             f"elements, got strides {t.stride()}")
    B, H, S, D = q.shape
    KV, Dv = k.shape[1], v.shape[-1]
    if tuple(k.shape) != (B, KV, S, D) or tuple(v.shape) != (B, KV, S, Dv):
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if KV < 1 or H % KV:
        raise ValueError(f"{KV} kv heads do not divide {H} heads")
    if D > MAX_HEAD_DIM or D % 4:
        raise ValueError(f"head dim {D}: the kernel takes multiples of 4 up "
                         f"to {MAX_HEAD_DIM}")
    if Dv > D or Dv < 1 or Dv % 4:
        raise ValueError(f"v head dim {Dv}: the kernel takes multiples of 4 "
                         f"up to q's head dim {D}")


def _empty_like_q(q: torch.Tensor, Dv: int) -> torch.Tensor:
    """An uninitialised [B,H,S,Dv] tensor whose batch, head and sequence
    dims are laid out in q's order (a layer's [B,S,H,D] view gives a
    [B,S,H,Dv] buffer seen as [B,H,S,Dv]), dense, head dim contiguous.
    The backward gives each gradient its input's order this way."""
    order = sorted(range(3), key=lambda d: -q.stride(d))   # outermost first
    shape = [q.shape[d] for d in order] + [Dv]
    buf = torch.empty(shape, dtype=q.dtype, device=q.device)
    return buf.permute(*[order.index(d) for d in range(3)], 3)


def _check_options(window, cap) -> None:
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    if cap is not None and not cap > 0:
        raise ValueError(f"softcap must be positive, got {cap}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: Optional[int] = None,
                         cap: Optional[float] = None,
                         scale: Optional[float] = None,
                         return_lse: bool = False):
    """Attention of CUDA tensors in ONE kernel launch: the contract of
    ``ref.attention_reference`` (q [B,H,S,D]; k [B,KV,S,D], v [B,KV,S,Dv]
    -> [B,H,S,Dv] in q's dtype, its first three dims laid out as q's).
    With ``return_lse`` -> (out, lse), lse the fp32 [B,H,S] log-sum-exp of
    each row's scaled, capped and masked scores
    (``ref.attention_lse_reference``), which the backward takes."""
    global LAUNCHES, TENSOR_CORE_LAUNCHES, CUDA_CORE_LAUNCHES
    _check(q, k, v)
    B, H, S, D = q.shape
    Dv = v.shape[-1]
    _check_options(window, cap)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = _empty_like_q(q, Dv)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    lib = nvcc.load(SOURCE, _bind)
    route = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.arcadia_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], 0 if lse is None else lse.data_ptr(),
            H * S, S, B, H, k.shape[1], S, D, Dv, int(causal),
            0 if window is None else int(window), float(scale),
            0.0 if cap is None else float(cap), _DTYPES[q.dtype], stream,
            ctypes.byref(route))
    if err != 0:
        raise RuntimeError(f"flash kernel launch failed: cudaError_t {err} "
                           f"(B={B}, H={H}, KV={k.shape[1]}, S={S}, D={D}, "
                         f"Dv={Dv}, "
                           f"{q.dtype}, route {route.value})")
    LAUNCHES += 1
    if ROUTES[route.value] == "tensor_cores":
        TENSOR_CORE_LAUNCHES += 1
    else:
        CUDA_CORE_LAUNCHES += 1
    return (out, lse) if return_lse else out


def flash_attention_backward_cuda(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, o: torch.Tensor,
                                  lse: torch.Tensor, do: torch.Tensor, *,
                                  causal: bool = True,
                                  window: Optional[int] = None,
                                  cap: Optional[float] = None,
                                  scale: Optional[float] = None):
    """(dq, dk, dv) of ``flash_attention_cuda`` at (q, k, v), given its
    output o [B,H,S,Dv], its ``lse`` and the cotangent ``do`` of o: the
    contract of ``ref.attention_backward_reference`` (on the tensor cores
    with dS rounded to bf16 where it meets Q and K, as
    ``ref.attention_backward_tc_reference``), in THREE kernel launches of
    the route ``backward_route`` chooses.  The gradients have their inputs'
    shapes, dtypes and memory orders.  q, k, v and o are read through their
    strides (as ``_check`` takes them); a ``do`` the route cannot read in
    place is copied once (``BACKWARD_DO_COPIES``).  A build or launch
    failure raises; nothing falls back to the other route."""
    global BACKWARD_LAUNCHES, BACKWARD_CALL_LAUNCHES, BACKWARD_DO_COPIES, \
        BACKWARD_TENSOR_CORE_LAUNCHES, BACKWARD_CUDA_CORE_LAUNCHES
    _check(q, k, v)
    B, H, S, D = q.shape
    KV, Dv = k.shape[1], v.shape[-1]
    _check_options(window, cap)
    for name, t in (("o", o), ("do", do)):
        if t.device != q.device or t.dtype != q.dtype or \
                tuple(t.shape) != (B, H, S, Dv):
            raise ValueError(f"{name} must be a {q.dtype} [B,H,S,Dv] tensor "
                             f"on {q.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if not _aligned(o):
        raise ValueError(f"o must have a contiguous head dim and strides "
                         f"aligned to 4 elements, got {o.stride()}")
    if lse.device != q.device or lse.dtype != torch.float32 or \
            tuple(lse.shape) != (B, H, S) or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous fp32 [B,H,S] tensor on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)}")
    route = backward_route(q, k, v, o, do)
    tc = route == "tensor_cores"
    if not (_tma_aligned(do) if tc else _aligned(do)):
        do = do.contiguous()
        BACKWARD_DO_COPIES += 1
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dq = _empty_like_q(q, D)
    dk = _empty_like_q(k, D)
    dv = _empty_like_q(v, Dv)
    if dq.numel() == 0:
        return dq, dk, dv
    delta = torch.empty_like(lse)
    lib = nvcc.load(BWD_TC_SOURCE, _bind_bwd_tc) if tc else \
        nvcc.load(BWD_SOURCE, _bind_bwd)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (*(t.data_ptr() for t in (q, k, v, o, do, lse, delta, dq, dk,
                                         dv)),
                *(s for t in (q, k, v, o, do, dq, dk, dv)
                  for s in t.stride()[:3]),
                H * S, S, B, H, KV, S, D, Dv, int(causal),
                0 if window is None else int(window), float(scale),
                0.0 if cap is None else float(cap))
        if tc:
            err = lib.arcadia_flash_attention_backward_tc(*args, stream)
        else:
            err = lib.arcadia_flash_attention_backward(
                *args, _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash backward launch failed: cudaError_t {err} "
                           f"(B={B}, H={H}, KV={KV}, S={S}, D={D}, Dv={Dv}, "
                           f"{q.dtype}, {route})")
    BACKWARD_LAUNCHES += 1
    BACKWARD_CALL_LAUNCHES += len(BWD_KERNELS)
    if tc:
        BACKWARD_TENSOR_CORE_LAUNCHES += 1
    else:
        BACKWARD_CUDA_CORE_LAUNCHES += 1
    return dq, dk, dv
