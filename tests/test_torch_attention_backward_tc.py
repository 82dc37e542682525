"""The tensor-core route of the port's flash-attention backward, on the
CPU: its mirror ``ref.attention_backward_tc_reference`` (the plain
backward with dS rounded to bf16 where it meets Q and K, the one rounding
the kernel ``csrc/flash_attention_bwd_tc.cu`` adds) against
``jax.value_and_grad`` of the JAX package's ``attention_reference`` and
against the plain backward; the planted faults against the mirror; the
route rule ``backward_route`` on CPU tensors' metadata; the route's plan.
Inputs come from numpy seeds and reach both packages as the same arrays.

Tolerances: 5e-2 of each gradient's largest value against JAX in bf16
(as ``test_torch_attention_backward.py``); against the plain backward the
row check the card holds the kernel to: each row within 2^-6 of its
largest value, but no less than 2^-8 of the gradient's largest.
"""

import math

import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ref
from test_torch_attention_backward import CASES, TOL, draw, jax_grads, rel, \
    torch_inputs

ROW_TOL, ROW_FLOOR = 2.0 ** -6, 2.0 ** -8


def row_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    den = want.abs().amax(-1).clamp_min(ROW_FLOOR * float(want.abs().max()))
    return float(((got - want).abs().amax(-1) / den.clamp_min(1e-30)).max())


def plain_and_mirror(name, seed, fault=None):
    kw = CASES[name][1]
    arrs = draw(CASES[name], seed)
    q, k, v, ct = torch_inputs(arrs, "bfloat16")
    o = ref.attention_reference(q, k, v, **kw)
    lse = ref.attention_lse_reference(q, k, **kw)
    plain = ref.attention_backward_reference(q, k, v, o, lse, ct, **kw)
    mirror = ref.attention_backward_tc_reference(q, k, v, o, lse, ct,
                                                 fault=fault, **kw)
    return arrs, kw, (q, k, v), plain, mirror


@pytest.mark.parametrize("name", list(CASES))
def test_mirror_matches_jax_grad_and_the_plain_backward(name):
    arrs, kw, inputs, plain, mirror = plain_and_mirror(name, seed=len(name))
    _, jg = jax_grads(arrs, kw, "bfloat16")
    for g, t in zip(mirror, inputs):
        assert g.dtype == t.dtype and g.shape == t.shape
    errs = [rel(g, w) for g, w in zip(mirror, jg)]
    assert max(errs) <= TOL["bfloat16"], errs
    rows = [row_err(g, w) for g, w in zip(mirror, plain)]
    assert max(rows) <= ROW_TOL, rows
    # dv does not meet dS: the mirror's is the plain backward's
    assert torch.equal(mirror[2], plain[2])


@pytest.mark.parametrize("name", ["causal", "gqa"])
def test_mirror_rounds_ds_where_it_meets_q_and_k(name):
    """The mirror differs from the plain backward (dS rounded), and in fp32
    it is the plain backward (rounding to fp32 changes nothing)."""
    _, kw, _, plain, mirror = plain_and_mirror(name, seed=2)
    assert not torch.equal(mirror[0], plain[0])
    assert not torch.equal(mirror[1], plain[1])
    q, k, v, ct = torch_inputs(draw(CASES[name], 2), "float32")
    o = ref.attention_reference(q, k, v, **kw)
    lse = ref.attention_lse_reference(q, k, **kw)
    for a, b in zip(ref.attention_backward_tc_reference(q, k, v, o, lse, ct,
                                                        **kw),
                    ref.attention_backward_reference(q, k, v, o, lse, ct,
                                                     **kw)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fault", ref.FAULTS)
def test_planted_faults_fail_against_the_mirror(fault):
    """Each wrong mirror misses the faithful one by more than the row check,
    at a case where the fault can bite (softcap, window, a group of two)."""
    _, _, _, _, right = plain_and_mirror("gqa", seed=11)
    _, _, _, _, wrong = plain_and_mirror("gqa", seed=11, fault=fault)
    assert max(row_err(g, w) for g, w in zip(wrong, right)) > ROW_TOL
    with pytest.raises(ValueError):
        plain_and_mirror("gqa", seed=11, fault="other")


# ------------------------------- the route -------------------------------- #

def bhsd(B, H, S, D, dtype=torch.bfloat16, layout="bhsd"):
    """A [B,H,S,D] tensor laid out as the layer passes it ("bshd": a view
    of [B,S,H,D] storage) or contiguous."""
    if layout == "bshd":
        return torch.zeros(B, S, H, D, dtype=dtype).transpose(1, 2)
    return torch.zeros(B, H, S, D, dtype=dtype)


def shifted(t: torch.Tensor, by: int = 4) -> torch.Tensor:
    buf = torch.zeros(t.numel() + by, dtype=t.dtype)
    return buf[by:].view(t.shape)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("D,Dv", fa.TENSOR_CORE_PAIRS)
def test_route_takes_the_tensor_core_pairs_in_bf16(D, Dv, layout):
    q, o = bhsd(2, 4, 40, D, layout=layout), bhsd(2, 4, 40, Dv, layout=layout)
    k, v = bhsd(2, 2, 40, D, layout=layout), bhsd(2, 2, 40, Dv, layout=layout)
    assert fa.backward_route(q, k, v, o, o) == "tensor_cores"
    f32 = [t.float() for t in (q, k, v, o)]
    assert fa.backward_route(*f32, f32[3]) == "cuda_cores"


def test_route_sends_other_pairs_and_misaligned_views_to_the_cuda_cores():
    q, k = bhsd(1, 4, 32, 24), bhsd(1, 2, 32, 24)
    v, o = bhsd(1, 2, 32, 16), bhsd(1, 4, 32, 16)
    assert fa.backward_route(q, k, v, o, o) == "cuda_cores"      # (24, 16)
    q, k = bhsd(1, 4, 32, 128), bhsd(1, 2, 32, 128)
    v, o = bhsd(1, 2, 32, 128), bhsd(1, 4, 32, 128)
    assert fa.backward_route(q, k, v, o, o) == "tensor_cores"
    for n in range(4):                  # one of q, k, v, o 8 bytes off
        ts = [q, k, v, o]
        ts[n] = shifted(ts[n])
        assert fa.backward_route(*ts, o) == "cuda_cores", n
    # dO is copied where TMA cannot read it: its layout does not choose
    assert fa.backward_route(q, k, v, o, shifted(o)) == "tensor_cores"
    strided = o.transpose(2, 3).contiguous().transpose(2, 3)
    assert fa.backward_route(q, k, v, o, strided) == "tensor_cores"
    assert fa.backward_route(q, k, v, o, o.float()) == "cuda_cores"
    # a sequence stride that is not a multiple of 8 elements (16 bytes)
    wide = torch.zeros(1, 32, 2, 132, dtype=torch.bfloat16)
    assert fa.backward_route(q, wide[..., :128].transpose(1, 2), v, o, o) \
        == "cuda_cores"


def test_route_reads_mlas_value_slice():
    """MLA's prefill passes v as the [..., 128:] half of its [B,S,H,256]
    key/value expansion: 256 bytes in, 16-byte aligned."""
    B, H, S = 1, 4, 48
    q, o = bhsd(B, H, S, 192, layout="bshd"), bhsd(B, H, S, 128)
    kv = torch.zeros(B, S, H, 256, dtype=torch.bfloat16)
    k = bhsd(B, H, S, 192, layout="bshd")
    v = kv[..., 128:].transpose(1, 2)
    assert fa.backward_route(q, k, v, o, o) == "tensor_cores"
    assert fa.backward_route(q, k, kv[..., 124:252].transpose(1, 2), o, o) \
        == "cuda_cores"


# -------------------------------- the plan -------------------------------- #

MAX_REGS = 240          # a consumer thread after setmaxnreg (kThreads 384)


@pytest.mark.parametrize("D,Dv", fa.TENSOR_CORE_PAIRS)
def test_tensor_core_plan_fits_shared_memory_and_registers(D, Dv):
    """The shared-memory plan of both launches fits 227 KB, and the fp32
    fragments a consumer thread keeps fit its 240 registers: a [64, N]
    accumulator is N/2 registers over a warpgroup's 128 threads, the packed
    bf16 A operand of a [64, 64] tile 16.  dK/dV: dK (D rounded up to a
    64-column box) + Sᵀ + dPᵀ + packed dSᵀ on one warpgroup, dV + Sᵀ +
    packed Pᵀ on the other; dQ: dQ + S + dP + packed dS."""
    plan = fa.backward_plan(torch.bfloat16, D, Dv)
    assert plan.route == "tensor_cores" and plan.launches == 3
    assert (plan.rows, plan.keys, plan.dq_rows, plan.dq_keys) == \
        (64, 64, 128, 64)
    assert max(plan.smem_bytes, plan.dq_smem_bytes) <= fa.MAX_SMEM
    wide, wide_v = 64 * math.ceil(D / 64), 64 * math.ceil(Dv / 64)
    tile = 64 * 64 // 128
    regs = dict(dk=wide // 2 + 2 * tile + tile // 2,
                dv=wide_v // 2 + tile + tile // 2,
                dq=wide // 2 + 2 * tile + tile // 2)
    assert max(regs.values()) <= MAX_REGS - 32, regs     # room for addresses
    # bytes: the tiles of 64 rows, 1 KB of alignment and the barriers
    k_tile, v_tile = wide * 128, wide_v * 128
    assert plan.smem_bytes == 1024 + 3 * (k_tile + v_tile) + 128
    assert plan.dq_smem_bytes == \
        1024 + (2 + plan.dq_stages) * (k_tile + v_tile) + 128
    assert plan.dq_stages == (1 if D == 256 else 2)
    # the CUDA-core plan of the same pair stays available by name
    cc = fa.backward_plan(torch.bfloat16, D, Dv, route="cuda_cores")
    assert cc.route == "cuda_cores" and cc.rows == 64
    with pytest.raises(ValueError):
        fa.backward_plan(torch.float32, D, Dv, route="tensor_cores")


def test_tensor_core_plan_refuses_pairs_it_has_no_kernel_for():
    with pytest.raises(ValueError):
        fa.backward_plan(torch.bfloat16, 96, 64, route="tensor_cores")
    assert fa.backward_plan(torch.bfloat16, 96, 64).route == "cuda_cores"
    with pytest.raises(ValueError):
        fa.backward_plan(torch.bfloat16, 128, 128, route="other")


def test_executed_work_of_the_route():
    """The host's count of what the tensor-core route executes per pair
    (``backward_executed_ops``) over what the function needs."""
    for D, Dv in fa.TENSOR_CORE_PAIRS:
        need = 2 * (3 * D + 2 * Dv)
        got = fa.backward_executed_ops(torch.bfloat16, D, Dv)
        wide, wide_v = 64 * math.ceil(D / 64), 64 * math.ceil(Dv / 64)
        assert got == 2 * (3 * D + 2 * Dv + wide_v + 2 * wide)
        assert 1.5 <= got / need <= 2.0
    # the mma.sync route: S and dP twice, dV, dK, dQ; fp32 three TF32
    # products each, bf16 dK and dQ twice (dS as hi + lo), widths rounded up
    # to the product's step (8 in fp32, 16 in bf16)
    assert fa.backward_executed_ops(torch.float32, 80, 80) == \
        3 * 2 * (4 * 80 + 3 * 80)
    assert fa.backward_executed_ops(torch.float32, 36, 20) == \
        3 * 2 * (4 * 40 + 3 * 24)
    assert fa.backward_executed_ops(torch.bfloat16, 96, 64) == \
        2 * (6 * 96 + 3 * 64)
    assert fa.backward_executed_ops(torch.bfloat16, 128, 128,
                                    route="cuda_cores") == 2 * 9 * 128
