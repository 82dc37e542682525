"""The port's chunked SSD backward (``ref.ssd_backward_reference``, the
passes of the backward kernel) against the gradients the JAX package
trains with — ``jax.grad`` through its ``ssd_reference`` (its Pallas
kernel has no gradient) — and against float64 ``torch.autograd`` through
the port's own ``ssd_reference``, on the same numpy-seeded inputs.

Tolerances, each of a gradient's largest magnitude: 1e-5 against JAX in
fp32 (the two fp32 evaluations sum in other orders; the largest gap seen
is 4.4e-6, on dA_log, a sum over every token); 1e-9 against float64
autograd (the same arithmetic in float64, round-off only, seen below
1e-14).  The check must fail a backward that does not carry the adjoint
across chunks or drops the inter-chunk terms of dC: the gradient of the
first half of the sequence alone (no adjoint from the second half) and of
the second half alone (no state from the first) are held against the
whole sequence's gradient.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.ssd_scan import ref as jref
from repro_torch.kernels.ssd_scan import ops, ref

JAX_TOL = 1e-5
F64_TOL = 1e-9
NAMES = ("dxh", "ddt", "dA_log", "dBm", "dCm")

# (B, S, H, P, G, N, chunk): G = 1 and 2, P and N 16 to 64, chunks of 16 to
# 64, S of one to four chunks
SHAPES = [
    (2, 64, 4, 32, 2, 16, 16),
    (1, 128, 2, 64, 1, 32, 32),
    (1, 96, 6, 16, 2, 16, 32),
    (2, 64, 4, 32, 1, 16, 64),
    (1, 64, 2, 16, 1, 64, 64),
    (1, 256, 4, 16, 2, 32, 64),
    (1, 48, 2, 16, 1, 16, 48),
]


def inputs(B, S, H, P, G, N, seed):
    """tests/test_kernels.py's draw of the scan's inputs, plus dy and a
    d(final state) from N(0, 1)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    xh = rng.normal(size=(B, S, H, P)).astype(f)
    dt = rng.uniform(0.05, 0.9, size=(B, S, H)).astype(f)
    A_log = rng.uniform(-1.0, 0.5, size=(H,)).astype(f)
    Bm = rng.normal(size=(B, S, G, N)).astype(f)
    Cm = rng.normal(size=(B, S, G, N)).astype(f)
    dy = rng.normal(size=(B, S, H, P)).astype(f)
    dstate = rng.normal(size=(B, H, P, N)).astype(f)
    return (xh, dt, A_log, Bm, Cm), dy, dstate


def jax_grads(args, dy, dstate, chunk):
    def loss(*a):
        y, st = jref.ssd_reference(*a, chunk=chunk)
        out = jnp.sum(y * dy)
        if dstate is not None:
            out = out + jnp.sum(st * dstate)
        return out
    return [np.asarray(g) for g in jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        *(jnp.asarray(a) for a in args))]


def rel_errs(got, want, names=NAMES):
    """max |got - want| / max |want|, per gradient."""
    return {n: float((torch.as_tensor(g).double()
                      - torch.as_tensor(w).double()).abs().max()
                     / torch.as_tensor(w).double().abs().max())
            for n, g, w in zip(names, got, want)}


def torch_args(args, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in args]


@pytest.mark.parametrize("with_dstate", [False, True],
                         ids=["no-dstate", "dstate"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_backward_matches_jax_grad(shape, with_dstate):
    *dims, chunk = shape
    args, dy, dstate = inputs(*dims, seed=sum(shape) + with_dstate)
    ds = dstate if with_dstate else None
    want = jax_grads(args, dy, ds, chunk)
    got = ref.ssd_backward_reference(
        *torch_args(args), torch.from_numpy(dy),
        None if ds is None else torch.from_numpy(ds), chunk)
    for g, a in zip(got, args):
        assert g.shape == a.shape and g.dtype == torch.float32
    errs = rel_errs(got, want)
    assert max(errs.values()) <= JAX_TOL, errs


@pytest.mark.parametrize("with_dstate", [False, True],
                         ids=["no-dstate", "dstate"])
@pytest.mark.parametrize("shape", SHAPES[:4], ids=str)
def test_backward_matches_float64_autograd(shape, with_dstate):
    *dims, chunk = shape
    args, dy, dstate = inputs(*dims, seed=3 * sum(shape) + with_dstate)
    a64 = [t.requires_grad_() for t in torch_args(args, torch.float64)]
    dy64 = torch.from_numpy(dy).double()
    ds64 = torch.from_numpy(dstate).double() if with_dstate else None
    y, st = ref.ssd_reference(*a64, chunk=chunk)
    assert y.dtype == st.dtype == torch.float64
    loss = (y * dy64).sum() + ((st * ds64).sum() if with_dstate else 0.0)
    want = torch.autograd.grad(loss, a64)
    got = ref.ssd_backward_reference(*(t.detach() for t in a64), dy64, ds64,
                                     chunk)
    for g in got:
        assert g.dtype == torch.float64
    errs = rel_errs(got, want)
    assert max(errs.values()) <= F64_TOL, errs


def test_cpu_autograd_through_ops_is_the_plain_version():
    """On CPU tensors ``ops.ssd`` is ``ref.ssd_reference`` under autograd:
    its gradient is the one the backward reference computes."""
    shape = (1, 64, 4, 16, 2, 16, 32)
    *dims, chunk = shape
    args, dy, dstate = inputs(*dims, seed=11)
    ts = [t.requires_grad_() for t in torch_args(args)]
    y, st = ops.ssd(*ts, chunk=chunk)
    loss = (y * torch.from_numpy(dy)).sum() + \
        (st * torch.from_numpy(dstate)).sum()
    auto = torch.autograd.grad(loss, ts)
    chunked = ref.ssd_backward_reference(
        *torch_args(args), torch.from_numpy(dy), torch.from_numpy(dstate),
        chunk)
    errs = rel_errs(chunked, auto)
    assert max(errs.values()) <= JAX_TOL, errs


@pytest.mark.parametrize("fault", ["adjoint not carried across chunks",
                                   "inter-chunk dC term dropped"])
def test_planted_faults_fail_the_check(fault):
    """A backward run on half the sequence misses what crosses the halves'
    boundary: the first half alone gets no adjoint from the second (G = 0
    at its last chunk's end), the second half alone no state from the
    first (h0 = 0 at its first chunk, so dC's and da's inter-chunk terms
    vanish).  Held against the whole gradient's half, each must fail."""
    shape = (1, 128, 4, 32, 2, 32, 32)
    *dims, chunk = shape
    args, dy, dstate = inputs(*dims, seed=5)
    ts, dyt = torch_args(args), torch.from_numpy(dy)
    whole = ref.ssd_backward_reference(*ts, dyt, torch.from_numpy(dstate),
                                       chunk)
    h = shape[1] // 2
    half = slice(0, h) if fault.startswith("adjoint") else slice(h, None)
    xh, dt, A_log, Bm, Cm = ts
    part = ref.ssd_backward_reference(
        xh[:, half], dt[:, half], A_log, Bm[:, half], Cm[:, half],
        dyt[:, half], torch.from_numpy(dstate) if half.start else None, chunk)
    errs = rel_errs((part[0], part[1], part[3], part[4]),
                    (whole[0][:, half], whole[1][:, half],
                     whole[3][:, half], whole[4][:, half]),
                    names=("dxh", "ddt", "dBm", "dCm"))
    key = "dCm" if fault.startswith("inter") else "dxh"
    assert errs[key] > 100 * JAX_TOL, errs


def test_plain_scan_gradient_is_finite_where_exp_overflows():
    """At mamba2-130m's decays (exp(A_log) up to 16, dt up to 0.1) and its
    256-token chunk, cum_i - cum_j above the diagonal reaches +100, whose
    exp overflows fp32.  The plain scan selects those entries away; its
    gradient must not turn the select's 0 times inf into NaN (it did: the
    full-width card-vs-CPU train step's CPU grads were NaN)."""
    B, S, H, P, G, N, Q = 1, 512, 4, 16, 1, 32, 256
    rng = np.random.default_rng(7)
    f = np.float32
    args = [torch.from_numpy(a) for a in (
        rng.normal(size=(B, S, H, P)).astype(f),
        rng.uniform(0.05, 0.1, size=(B, S, H)).astype(f),
        np.log(np.full(H, 16.0)).astype(f),
        rng.normal(size=(B, S, G, N)).astype(f),
        rng.normal(size=(B, S, G, N)).astype(f))]
    dy = torch.from_numpy(rng.normal(size=(B, S, H, P)).astype(f))
    leaves = [a.clone().requires_grad_() for a in args]
    y, _ = ops.ssd(*leaves, chunk=Q)
    auto = torch.autograd.grad((y * dy).sum(), leaves)
    assert all(bool(torch.isfinite(g).all()) for g in auto)
    exact = ref.ssd_backward_reference(*(a.double() for a in args),
                                       dy.double(), None, Q)
    for got in (auto, ref.ssd_backward_reference(*args, dy, None, Q)):
        errs = rel_errs(got, exact)
        assert max(errs.values()) <= 1e-4, errs


# --------------- the tensor-core backward's CPU mirror --------------------
#
# ``ref.ssd_backward_tc_reference`` rounds where ``csrc/ssd_scan_bwd_tc.cu``
# rounds (bf16 operands, hi + lo splits of the pair weights, fp32 sums,
# fp64 d(cum)).  Held, as the kernel is on the card, within 5e-2 of each
# gradient's largest magnitude (bf16, the forward's tolerance) of the JAX
# package's gradient and of float64 autograd; the mirror's own distance
# from float64 at these draws is 1e-3 to 3e-3 (the bf16 rounding of dxh,
# dBm and dCm).  At one chunk without d(state) only the pair terms remain:
# there, on fp32 outputs, the mirror is within 6e-6 of float64 and one
# bf16 rounding of the pair weights (no lo operand) 1e-3 or more, so 1e-4
# tells the two apart.

TC_TOL = 5e-2
PAIR_TERM_TOL = 1e-4
BF16 = torch.bfloat16

# the card tests' bf16 shapes (tests/test_torch_cuda.py BWD_SHAPES, and
# TC_BWD_SHAPES' grouped and widest ones)
CARD_SHAPES = [(2, 64, 4, 32, 2, 16, 16), (1, 128, 2, 64, 1, 32, 32),
               (1, 96, 6, 16, 2, 16, 32), (1, 64, 2, 16, 1, 64, 64),
               (1, 512, 24, 64, 1, 128, 256), (2, 512, 16, 64, 8, 128, 256),
               (1, 256, 4, 128, 2, 256, 128)]


def card_inputs(B, S, H, P, G, N, seed):
    """tests/test_torch_cuda.py's ``bwd_inputs`` draw in bf16, on the CPU:
    at N = 128 dt and A as mamba2-130m initialises them."""
    rng = np.random.default_rng(seed)
    mixer = N == 128
    t = lambda a, d=torch.float32: torch.from_numpy(  # noqa: E731
        np.asarray(a, np.float32)).to(d)
    dt = rng.uniform(1e-3, 0.1, (B, S, H)) if mixer else \
        rng.uniform(0.05, 0.9, (B, S, H))
    A = np.log(rng.uniform(1.0, 16.0, H)) if mixer else \
        rng.uniform(-1.0, 0.5, H)
    args = (t(rng.standard_normal((B, S, H, P)), BF16), t(dt), t(A),
            t(rng.standard_normal((B, S, G, N)), BF16),
            t(rng.standard_normal((B, S, G, N)), BF16))
    return args, t(rng.standard_normal((B, S, H, P)), BF16), \
        t(rng.standard_normal((B, H, P, N)))


def float64_grads(args, dy, dstate, chunk):
    return ref.ssd_backward_reference(
        *(a.double() for a in args), dy.double(),
        None if dstate is None else dstate.double(), chunk)


@pytest.mark.parametrize("with_dstate", [False, True],
                         ids=["no-dstate", "dstate"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_tc_mirror_matches_jax_and_float64(shape, with_dstate):
    *dims, chunk = shape
    args, dy, dstate = inputs(*dims, seed=7 * sum(shape) + with_dstate)
    bf = [torch.from_numpy(a).to(BF16) if k in (0, 3, 4)
          else torch.from_numpy(a) for k, a in enumerate(args)]
    dyb = torch.from_numpy(dy).to(BF16)
    ds = torch.from_numpy(dstate) if with_dstate else None
    # the JAX package's gradient at the bf16 values, in fp32
    vals = [np.asarray(a.float()) for a in bf]

    def loss(*a):
        y, st = jref.ssd_reference(*a, chunk=chunk)
        out = jnp.sum(y * jnp.asarray(np.asarray(dyb.float())))
        if with_dstate:
            out = out + jnp.sum(st * jnp.asarray(dstate))
        return out
    _, want_jax = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(v) for v in vals))
    got = ref.ssd_backward_tc_reference(*bf, dyb, ds, chunk)
    for g, a in zip(got, bf):
        assert g.shape == a.shape and g.dtype == a.dtype
    for want in ([np.asarray(w) for w in want_jax],
                 float64_grads(bf, dyb, ds, chunk)):
        errs = rel_errs(got, want)
        assert max(errs.values()) <= TC_TOL, errs


@pytest.mark.parametrize("with_dstate", [False, True],
                         ids=["no-dstate", "dstate"])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
def test_tc_mirror_at_the_card_tests_draw(shape, with_dstate):
    *dims, chunk = shape
    args, dy, ds = card_inputs(*dims, seed=sum(shape))
    ds = ds if with_dstate else None
    got = ref.ssd_backward_tc_reference(*args, dy, ds, chunk)
    errs = rel_errs(got, float64_grads(args, dy, ds, chunk))
    assert max(errs.values()) <= TC_TOL, errs


PAIR_SHAPES = [(1, 256, 24, 64, 1, 128, 256), (2, 64, 4, 32, 2, 16, 64),
               (1, 128, 2, 64, 1, 32, 128)]


@pytest.mark.parametrize("shape", PAIR_SHAPES, ids=str)
def test_tc_mirror_pair_terms_need_the_lo_operands(shape):
    """At one chunk without d(state), on fp32 outputs (bf16 values in fp32),
    the mirror's pair terms are within PAIR_TERM_TOL of float64; with the
    lo operands dropped they are not."""
    *dims, chunk = shape
    args, dy, _ = card_inputs(*dims, seed=len(shape) + shape[2])
    f32 = [a.float() for a in args]
    exact = float64_grads(args, dy, None, chunk)
    names = ("dxh", "ddt", "dBm", "dCm")
    pick = lambda g: (g[0], g[1], g[3], g[4])  # noqa: E731
    good = rel_errs(pick(ref.ssd_backward_tc_reference(
        *f32, dy.float(), None, chunk)), pick(exact), names)
    assert max(good.values()) <= PAIR_TERM_TOL, good
    bad = rel_errs(pick(ref.ssd_backward_tc_reference(
        *f32, dy.float(), None, chunk, fault="lo dropped")), pick(exact),
        names)
    assert min(bad.values()) > PAIR_TERM_TOL, bad


@pytest.mark.parametrize("fault", ["head summed twice", "adjoint dropped"])
@pytest.mark.parametrize("shape", [(1, 512, 24, 64, 1, 128, 256),
                                   (1, 256, 4, 32, 2, 16, 64)], ids=str)
def test_tc_mirror_planted_faults_fail(shape, fault):
    """A group's first head summed twice into W's sum moves dBm and dCm,
    and an adjoint not carried across chunks moves dxh, past 5e-2 of
    float64 (at the same draw the mirror itself is within it)."""
    *dims, chunk = shape
    args, dy, ds = card_inputs(*dims, seed=3)
    exact = float64_grads(args, dy, ds, chunk)
    assert max(rel_errs(ref.ssd_backward_tc_reference(
        *args, dy, ds, chunk), exact).values()) <= TC_TOL
    errs = rel_errs(ref.ssd_backward_tc_reference(
        *args, dy, ds, chunk, fault=fault), exact)
    keys = ("dBm", "dCm") if fault.startswith("head") else ("dxh",)
    assert min(errs[k] for k in keys) > TC_TOL, errs


def test_tc_mirror_refuses_an_unknown_fault():
    args, dy, _ = card_inputs(1, 64, 2, 16, 1, 16, seed=0)
    with pytest.raises(ValueError, match="unknown fault"):
        ref.ssd_backward_tc_reference(*args, dy, None, 64, fault="other")


# ------------------------------ routing -----------------------------------

def _mixer(B, S, H, P, G, N, dtype=BF16, extra=0):
    """xh, Bm, Cm as views of one [B, S, H·P + 2·G·N + extra] tensor."""
    conv = torch.zeros(B, S, H * P + 2 * G * N + extra, dtype=dtype)
    xi, bv, cv, _ = torch.split(conv, [H * P, G * N, G * N, extra], dim=-1)
    return (xi.reshape(B, S, H, P), bv.reshape(B, S, G, N),
            cv.reshape(B, S, G, N))


def _shifted(shape, dtype=BF16):
    """A contiguous tensor whose pointer is 2 bytes past 16-byte alignment."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


@pytest.mark.parametrize("case,want", [
    ("bf16 contiguous", "tensor_cores"),
    ("bf16 mixer views", "tensor_cores"),
    ("fp32", "cuda_cores"),
    ("float64", "cuda_cores"),
    ("dy fp32", "cuda_cores"),
    ("chunk 32", "cuda_cores"),
    ("chunk 96", "cuda_cores"),
    ("P 24", "cuda_cores"),
    ("N 136", "cuda_cores"),
    ("P 144", "cuda_cores"),
    ("N 272", "cuda_cores"),
    ("seq not a multiple of the chunk", "cuda_cores"),
    ("xh misaligned", "cuda_cores"),
    ("dy misaligned", "cuda_cores"),
    ("dy strided", "cuda_cores"),
    ("dy token stride not 8k", "cuda_cores"),
    ("dy a transposed view", "cuda_cores"),
    ("dy a strided view, aligned", "tensor_cores"),
    ("mixer views, token stride not 8k", "cuda_cores"),
])
def test_backward_route(case, want):
    from repro_torch.kernels.ssd_scan import ssd_scan

    B, S, H, P, G, N, Q = 2, 256, 4, 64, 1, 128, 128
    xh = torch.zeros(B, S, H, P, dtype=BF16)
    Bm = torch.zeros(B, S, G, N, dtype=BF16)
    Cm, dy = Bm.clone(), xh.clone()
    if case == "bf16 mixer views":
        xh, Bm, Cm = _mixer(B, S, H, P, G, N)
    elif case in ("fp32", "float64"):
        dt_ = torch.float32 if case == "fp32" else torch.float64
        xh, Bm, Cm, dy = (t.to(dt_) for t in (xh, Bm, Cm, dy))
    elif case == "dy fp32":
        dy = dy.float()
    elif case.startswith("chunk"):
        Q = int(case.split()[1])
    elif case.startswith("P "):
        P = int(case.split()[1])
        xh = dy = torch.zeros(B, S, H, P, dtype=BF16)
    elif case.startswith("N "):
        N = int(case.split()[1])
        Bm = Cm = torch.zeros(B, S, G, N, dtype=BF16)
    elif case.startswith("seq"):
        xh = dy = torch.zeros(B, 320, H, P, dtype=BF16)
        Bm = Cm = torch.zeros(B, 320, G, N, dtype=BF16)
        Q = 256
    elif case == "xh misaligned":
        xh = _shifted((B, S, H, P))
    elif case == "dy misaligned":
        dy = _shifted((B, S, H, P))
    elif case == "dy strided":
        dy = torch.zeros(B, S, H, 2 * P, dtype=BF16)[..., ::2]
    elif case == "dy token stride not 8k":
        dy = torch.zeros(B, S, H * P + 4, dtype=BF16)[..., :H * P].view(
            B, S, H, P)
    elif case == "dy a transposed view":
        dy = torch.zeros(B, S, P, H, dtype=BF16).transpose(2, 3)
    elif case == "dy a strided view, aligned":
        dy = torch.zeros(B, S, H * P + 8, dtype=BF16)[..., :H * P].view(
            B, S, H, P)
    elif case.startswith("mixer views, token"):
        xh, Bm, Cm = _mixer(B, S, H, P, G, N, extra=4)
    assert ssd_scan.backward_route(xh, Bm, Cm, dy, Q) == want


@pytest.mark.parametrize("P", [16, 48, 64, 128])
@pytest.mark.parametrize("N", [16, 80, 128, 256])
def test_tc_backward_plan_fits(P, N):
    """Every launch of the tensor-core backward fits in a block's 227 KB at
    P <= 128 and N <= 256 (chunks of 64 to 512 tokens)."""
    from repro_torch.kernels.ssd_scan import ssd_scan

    for Q in (64, 128, 256, 512):
        plan = ssd_scan.bwd_tc_plan(P, N, Q)
        assert len(plan) == 5 and max(plan) <= ssd_scan.MAX_SMEM, (Q, plan)
        assert min(plan) > 0
    assert ssd_scan.bwd_tc_plan(64, 128, 256) == (56448, 76288, 48128, 90112,
                                                  6144)
