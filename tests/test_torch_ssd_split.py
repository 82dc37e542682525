"""The arithmetic of the SSD scan's ``cuda_cores`` route, mirrored on the CPU.

The route's kernels (``csrc/ssd_scan.cu``, ``csrc/ssd_scan_bwd.cu``) run
every product on the tensor cores; in fp32 each product a·b is three TF32
products aₗ·bₕ + aₕ·bₗ + aₕ·bₕ (hi = tf32(v), lo = tf32(v - hi), rounded as
``cvt.rna.tf32.f32`` rounds), in the chunked passes of the tensor-core
route, with cum in fp64 and h_prev, h0 and G kept in fp32.
``ref.ssd_split_reference`` and ``ref.ssd_backward_split_reference`` do the
same arithmetic with torch on the CPU.  They are held here, on numpy-seeded
inputs at the CPU tests' shapes and at mamba2-130m's widths (P 64, N 128,
chunk 256), to two oracles:

* the JAX package's ``ssd_reference`` (and its Pallas kernel in interpret
  mode) and ``jax.grad`` of it, within 1e-4 of each output's largest
  value — the fp32 tolerance the card holds the kernels to;
* float64: the scan at N = 128 no further from the token-by-token float64
  recurrence than the plain fp32 version, the gradient within 4 times the
  plain fp32 backward's distance from the float64 chunked backward (or
  2e-5 of each gradient's largest value) — the card tests' bounds.

The single TF32 product (``products=1``, 11 bits) must miss the 1e-4
check at every case: a kernel that dropped the split would fail it.  bf16
on this route keeps the tensor-core route's roundings, so the card holds
it to ``ssd_three_pass_reference`` and ``ssd_backward_tc_reference``;
here those mirrors are held to the JAX package at the shapes only this
route takes (chunks of 16 and 100 tokens, widths that are not multiples
of 16).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.ssd_scan import ref as jref
from repro.kernels.ssd_scan.ssd_scan import ssd_pallas
from repro_torch.kernels.ssd_scan import ref, ssd_scan

TOL = 1e-4                  # fp32, of each output's largest value
BF16_TOL = 5e-2
BLOCK_TOL = 2.0 ** -6       # bf16, per (batch, head, chunk) block of y
NAMES = ("dxh", "ddt", "dA_log", "dBm", "dCm")

# (B, S, H, P, G, N, chunk), mixer draw: tests/test_kernels.py's shapes,
# mamba2-130m's widths over two chunks (the model's dt and A draw), one
# ragged chunk of 100 tokens at those widths, and widths that are not
# multiples of 16
CASES = {
    "2x64x4x32-G2-N16-Q16": ((2, 64, 4, 32, 2, 16, 16), False),
    "1x128x2x64-G1-N32-Q32": ((1, 128, 2, 64, 1, 32, 32), False),
    "1x96x6x16-G3-N8-Q16": ((1, 96, 6, 16, 3, 8, 16), False),
    "2x64x4x32-G4-N16-Q64": ((2, 64, 4, 32, 4, 16, 64), False),
    "mamba2-widths": ((1, 512, 24, 64, 1, 128, 256), True),
    "mamba2-widths-Q100": ((1, 100, 24, 64, 1, 128, 256), True),
    "P20-N24-Q48": ((1, 96, 4, 20, 2, 24, 48), False),
}
PALLAS = [k for k in CASES if k not in ("mamba2-widths-Q100", "P20-N24-Q48")]


def draw(shape, mixer, seed):
    """xh, dt, A_log, Bm, Cm, dy and d(final state) as float32 numpy
    arrays: tests/test_kernels.py's draw, or (``mixer``) dt and A as
    mamba2-130m initialises them."""
    B, S, H, P, G, N, _ = shape
    rng = np.random.default_rng(seed)
    f = np.float32
    xh = rng.normal(size=(B, S, H, P)).astype(f)
    if mixer:
        dt = rng.uniform(1e-3, 0.1, size=(B, S, H)).astype(f)
        A_log = np.log(rng.uniform(1.0, 16.0, size=(H,))).astype(f)
    else:
        dt = rng.uniform(0.05, 0.9, size=(B, S, H)).astype(f)
        A_log = rng.uniform(-1.0, 0.5, size=(H,)).astype(f)
    Bm = rng.normal(size=(B, S, G, N)).astype(f)
    Cm = rng.normal(size=(B, S, G, N)).astype(f)
    dy = rng.normal(size=(B, S, H, P)).astype(f)
    ds = rng.normal(size=(B, H, P, N)).astype(f)
    return (xh, dt, A_log, Bm, Cm), dy, ds


def torch_of(arrs, dtype=torch.float32):
    xh, dt, A_log, Bm, Cm = (torch.from_numpy(a) for a in arrs)
    return xh.to(dtype), dt, A_log, Bm.to(dtype), Cm.to(dtype)


def rel_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    g = torch.as_tensor(np.asarray(got, np.float64) if not
                        isinstance(got, torch.Tensor) else got).double()
    w = torch.as_tensor(np.asarray(want, np.float64) if not
                        isinstance(want, torch.Tensor) else want).double()
    return float((g - w).abs().max() / w.abs().max())


def jax_scan(args, chunk, pallas=False):
    ja = [jnp.asarray(a) for a in args]
    if pallas:
        return ssd_pallas(*ja, chunk=chunk, interpret=True)
    return jref.ssd_reference(*ja, chunk=chunk)


def jax_grads(args, dy, ds, chunk):
    """jax.grad of the JAX package's reference for the cotangents dy and
    d(final state)."""
    def loss(*a):
        y, st = jref.ssd_reference(*a, chunk=chunk)
        out = jnp.sum(y * dy)
        if ds is not None:
            out = out + jnp.sum(st * ds)
        return out
    return [np.asarray(g) for g in jax.jit(jax.grad(
        loss, argnums=(0, 1, 2, 3, 4)))(*(jnp.asarray(a) for a in args))]


@pytest.fixture(scope="module")
def grads():
    """Each case's draw and JAX gradient (with a d(state)), computed once."""
    out = {}
    for name, (shape, mixer) in CASES.items():
        args, dy, ds = draw(shape, mixer, sum(shape))
        out[name] = (args, dy, ds, jax_grads(args, dy, ds, shape[-1]))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_split_scan_matches_the_jax_reference(name):
    shape, mixer = CASES[name]
    args, _, _ = draw(shape, mixer, sum(shape))
    y, st = ref.ssd_split_reference(*torch_of(args), chunk=shape[-1])
    assert y.dtype == st.dtype == torch.float32
    y_j, st_j = jax_scan(args, shape[-1])
    assert rel_err(y, y_j) <= TOL
    assert rel_err(st, st_j) <= TOL


@pytest.mark.parametrize("name", PALLAS)
def test_split_scan_matches_the_pallas_kernel_in_interpret_mode(name):
    shape, mixer = CASES[name]
    args, _, _ = draw(shape, mixer, 3 * sum(shape))
    y, st = ref.ssd_split_reference(*torch_of(args), chunk=shape[-1])
    y_k, st_k = jax_scan(args, shape[-1], pallas=True)
    assert rel_err(y, y_k) <= TOL
    assert rel_err(st, st_k) <= TOL


@pytest.mark.parametrize("name", list(CASES))
def test_split_backward_matches_jax_grad(name, grads):
    args, dy, ds, want = grads[name]
    got = ref.ssd_backward_split_reference(
        *torch_of(args), torch.from_numpy(dy), torch.from_numpy(ds),
        CASES[name][0][-1])
    for g, a in zip(got, args):
        assert g.shape == a.shape and g.dtype == torch.float32
    errs = {n: rel_err(g, w) for n, g, w in zip(NAMES, got, want)}
    assert max(errs.values()) <= TOL, errs


@pytest.mark.parametrize("name", ["1x128x2x64-G1-N32-Q32", "mamba2-widths"])
def test_split_backward_without_a_state_cotangent(name):
    shape, mixer = CASES[name]
    args, dy, _ = draw(shape, mixer, 5 * sum(shape))
    want = jax_grads(args, dy, None, shape[-1])
    got = ref.ssd_backward_split_reference(*torch_of(args),
                                           torch.from_numpy(dy), None,
                                           shape[-1])
    errs = {n: rel_err(g, w) for n, g, w in zip(NAMES, got, want)}
    assert max(errs.values()) <= TOL, errs


def err_from_exact(got, exact) -> float:
    """Worst |got - exact| / (1 + |exact|) (the card tests' measure)."""
    return float(((got.double() - exact).abs() / (1 + exact.abs())).max())


@pytest.mark.parametrize("S,mixer", [(100, False), (512, False),
                                     (512, True)])
def test_split_scan_no_further_from_float64_than_plain(S, mixer):
    """At mamba2-130m's head widths (H 24, P 64, N 128, Q 256), with the
    tests' dt draw (cumulative decays near -200) and the model's: the
    split, like the kernel it mirrors, sums cum in fp64 and is no further
    from the float64 recurrence than the plain fp32 version
    (tests/test_torch_cuda.py::test_ssd_kernel_as_close_to_float64_as_plain)."""
    args, _, _ = draw((1, S, 24, 64, 1, 128, 256), mixer, S + 1)
    a = torch_of(args)
    exact = ref.ssd_sequential_oracle(*(t.double() for t in a))
    split = ref.ssd_split_reference(*a, chunk=256)
    plain = ref.ssd_reference(*a, chunk=256)
    for k, p, e in zip(split, plain, exact):
        assert err_from_exact(k, e) <= err_from_exact(p, e)


@pytest.mark.parametrize("name", list(CASES)[:4])
def test_split_scan_near_the_float64_recurrence(name):
    shape, mixer = CASES[name]
    args, _, _ = draw(shape, mixer, 7 * sum(shape))
    a = torch_of(args)
    exact = ref.ssd_sequential_oracle(*(t.double() for t in a))
    for got, e in zip(ref.ssd_split_reference(*a, chunk=shape[-1]), exact):
        assert rel_err(got, e) <= TOL


@pytest.mark.parametrize("seed", [1, 9])
def test_split_backward_near_float64(seed):
    """tests/test_torch_cuda.py::test_ssd_backward_of_fp32_is_near_float64's
    draw and bound: each gradient within 4 times the plain fp32 backward's
    distance from the float64 chunked backward, or 2e-5 of its largest
    value.  At seed 1 dA_log sums terms that cancel (the plain version is
    1.2e-4 from float64 there); the split stays within that bound with
    every product on the tensor cores."""
    B, S, H, P, G, N, Q = 1, 128, 2, 64, 1, 32, 32
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    dt, A = f(rng.uniform(0.05, 0.9, (B, S, H))), f(rng.uniform(-1.0, 0.5, H))
    args = (f(rng.standard_normal((B, S, H, P))), dt, A,
            f(rng.standard_normal((B, S, G, N))),
            f(rng.standard_normal((B, S, G, N))))
    dy, ds = f(rng.standard_normal((B, S, H, P))), \
        f(rng.standard_normal((B, H, P, N)))
    got = ref.ssd_backward_split_reference(*args, dy, ds, Q)
    plain = ref.ssd_backward_reference(*args, dy, ds, Q)
    exact = ref.ssd_backward_reference(*(a.double() for a in args),
                                       dy.double(), ds.double(), Q)
    for n, g, p, e in zip(NAMES, got, plain, exact):
        assert rel_err(g, e) <= max(4 * rel_err(p, e), 2e-5), n


@pytest.mark.parametrize("name", list(CASES))
def test_one_tf32_product_misses_the_check(name, grads):
    """tf32(a)·tf32(b) alone keeps 11 bits of a product: the scan or its
    gradient then misses the 1e-4 check against the JAX package."""
    shape, _ = CASES[name]
    args, dy, ds, want = grads[name]
    a = torch_of(args)
    y, st = ref.ssd_split_reference(*a, chunk=shape[-1], products=1)
    y_j, st_j = jax_scan(args, shape[-1])
    got = ref.ssd_backward_split_reference(
        *a, torch.from_numpy(dy), torch.from_numpy(ds), shape[-1],
        products=1)
    assert max(rel_err(y, y_j), rel_err(st, st_j)) > TOL
    assert max(rel_err(g, w) for g, w in zip(got, want)) > TOL


def test_split_takes_fp32_and_one_or_three_products():
    args, dy, ds = draw((1, 32, 2, 16, 1, 16, 16), False, 0)
    a = torch_of(args)
    with pytest.raises(TypeError):
        ref.ssd_split_reference(*torch_of(args, torch.bfloat16), chunk=16)
    with pytest.raises(ValueError):
        ref.ssd_split_reference(*a, chunk=16, products=2)
    with pytest.raises(TypeError):
        ref.ssd_backward_split_reference(
            *torch_of(args, torch.bfloat16),
            torch.from_numpy(dy).bfloat16(), None, 16)


# bf16 shapes the tensor-core routes refuse: a chunk of 16, one ragged
# chunk of 100 tokens at mamba2's widths, widths that are not multiples of
# 16 (the card runs them on this route and holds it to these mirrors)
BF16_CASES = {
    "Q16": ((2, 64, 4, 32, 2, 16, 16), False),
    "mamba2-widths-Q100": ((1, 100, 24, 64, 1, 128, 256), True),
    "P20-N24-Q48": ((1, 96, 4, 20, 2, 24, 48), False),
}


@pytest.mark.parametrize("name", list(BF16_CASES))
def test_bf16_on_this_route_keeps_the_tensor_core_roundings(name):
    """The router sends these bf16 inputs to the ``cuda_cores`` route, which
    rounds as the tensor-core route does: its mirrors hold to the JAX
    package in bf16 — y within 5e-2 elementwise and 2^-6 per (batch, head,
    chunk) block, the state within 5e-2, each gradient within 5e-2 of its
    largest value against jax.grad on the same bf16 values."""
    shape, mixer = BF16_CASES[name]
    chunk = shape[-1]
    args, dy, ds = draw(shape, mixer, 11 * sum(shape))
    a = torch_of(args, torch.bfloat16)
    dyb = torch.from_numpy(dy).bfloat16()
    assert ssd_scan.route(a[0], a[3], a[4], chunk) == "cuda_cores"
    assert ssd_scan.backward_route(a[0], a[3], a[4], dyb, chunk) == \
        "cuda_cores"
    y, st = ref.ssd_three_pass_reference(*a, chunk=chunk)
    y_j, st_j = jref.ssd_reference(
        *(jnp.asarray(t.float().numpy()) for t in a), chunk=chunk)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_j),
                               atol=BF16_TOL, rtol=BF16_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_j),
                               atol=BF16_TOL, rtol=BF16_TOL)
    assert ref.chunk_block_rel_err(y, torch.from_numpy(np.array(y_j)),
                                   chunk) <= BLOCK_TOL
    values = [t.float().numpy() for t in a]
    want = jax_grads(values, dyb.float().numpy(), ds, chunk)
    got = ref.ssd_backward_tc_reference(*a, dyb, torch.from_numpy(ds), chunk)
    errs = {n: rel_err(g.float(), w) for n, g, w in zip(NAMES, got, want)}
    assert max(errs.values()) <= BF16_TOL, errs


def test_cuda_core_route_copies_only_views_it_cannot_read():
    """The CUDA-core wrappers read a view through its strides when its last
    dimension is contiguous (the mixer's split of its conv output goes in
    as it is) and copy any other: autograd's expanded cotangent of
    ``y.sum()`` (every stride 0) and a transposed view."""
    conv = torch.randn(2, 8, 3 * 16 + 2 * 8)
    xi = conv[..., :48].reshape(2, 8, 3, 16)
    assert xi.stride(3) == 1 and ssd_scan._readable(xi) is xi
    one = torch.randn(2, 8, 3, 4)[..., :1]
    assert ssd_scan._readable(one) is one
    for view in (torch.ones(()).expand(2, 8, 3, 16),
                 torch.randn(2, 8, 16, 3).transpose(2, 3)):
        got = ssd_scan._readable(view)
        assert got.stride(3) == 1 and torch.equal(got, view)


def test_cuda_core_plans_fit_and_match_the_sources():
    """Every width the route takes (P <= 128; N <= 256 for the gradient)
    fits the 227 KB a block may use at chunks up to 2048 in either dtype,
    and the wrapper's constants are the sources' (the card tests hold the
    plans to the built libraries')."""
    import re
    for src in (ssd_scan.SOURCE, ssd_scan.BWD_SOURCE):
        consts = {k: int(v) for k, v in re.findall(
            r"constexpr int (k\w+) = (\d+);", src.read_text())}
        assert (consts["kTile"], consts["kSlice"], consts["kMaxP"],
                consts["kMaxSmem"]) == (ssd_scan.ROW_TILE, ssd_scan.SLICE,
                                        ssd_scan.MAX_P, ssd_scan.MAX_SMEM)
        rows = consts.get("kStateRows", consts.get("kSumRows"))
        block = consts.get("kStateBlock", consts.get("kSumBlock"))
        assert (rows, block) == (ssd_scan.STATE_ROWS, ssd_scan.STATE_BLOCK)
    for dtype in (torch.float32, torch.bfloat16):
        for P in range(1, ssd_scan.MAX_P + 1, 7):
            for N in (8, 16, 100, 128, 256):
                for Q in (16, 100, 256, 2048):
                    assert max(ssd_scan.plan(P, N, Q, dtype)) <= \
                        ssd_scan.MAX_SMEM, (P, N, Q, dtype)
                    assert max(ssd_scan.bwd_plan(P, N, Q, dtype)) <= \
                        ssd_scan.MAX_SMEM, (P, N, Q, dtype)
    # mamba2-130m's widths in fp32: the chunk-state and chunk-output
    # launches' shared bytes
    assert ssd_scan.plan(64, 128, 256, torch.float32) == (109696, 76800)
