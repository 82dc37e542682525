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
