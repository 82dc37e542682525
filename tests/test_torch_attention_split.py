"""The fp32 arithmetic of the mma.sync flash kernels, mirrored on the CPU.

The kernels of the ``"cuda_cores"`` route take each fp32 product a·b as
three TF32 products aₗ·bₕ + aₕ·bₗ + aₕ·bₕ (hi = tf32(x), lo = tf32(x - hi),
rounded as ``cvt.rna.tf32.f32`` rounds), all but the backward's dP = dO·Vᵀ,
which stays in fp32.  ``ref.attention_split_reference`` and
``ref.attention_backward_split_reference`` do the same arithmetic with
torch on the CPU.  They are held here, at the card tests' draws (numpy's
normal, q scaled by 16 into the softcap's range) and at a slice of gemma2's
global layer (1 × 2048, 2 heads over 1, D 256), to two oracles:

* the JAX package's ``attention_reference`` and ``jax.value_and_grad`` of
  it in fp32, at the card tests' fp32 tolerance ``FLASH_TOL`` = 2e-5: the
  output elementwise within 2e-5 + 2e-5·|jax| (``check_flash``), each
  gradient within 2e-5 of its largest magnitude (the plain backward's fp32
  bound in ``test_torch_attention_backward.py``).  The split keeps 22 of
  fp32's 24 bits a product and drops aₗ·bₗ (2^-22 of it), so it stays
  within the bound the fp32 kernels were held to;
* float64 autograd of the plain forward, at the same 2e-5: the split is
  as close to the exact function as fp32 arithmetic is.

The single TF32 product (``products=1``, 11 bits) must miss both checks
at every case: a kernel that dropped the split would fail them.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.flash_attention.ref import attention_reference as jax_ref
from repro_torch.kernels.flash_attention import ref

FLASH_TOL = 2e-5            # tests/test_torch_cuda.py's fp32 tolerance

# (B, H, KV, S, D, Dv), q's scale, options
CASES = {
    "scores-x16-cap": ((1, 4, 2, 256, 64, 64), 16.0, dict(causal=True, cap=50.0)),
    "scores-x16-window-cap": ((1, 4, 2, 256, 64, 64), 16.0,
                              dict(causal=True, window=64, cap=30.0)),
    "gemma2-global-slice": ((1, 2, 1, 2048, 256, 256), 1.0,
                            dict(causal=True, cap=50.0)),
    "mla-dv-below-d": ((1, 4, 4, 200, 192, 128), 1.0,
                       dict(causal=True, scale=1.0 / math.sqrt(192))),
    "hubert-d80": ((2, 4, 4, 150, 80, 80), 1.0, dict(causal=False)),
}


def draw(name, seed=7):
    """q, k, v and the cotangent of o as float32 numpy arrays."""
    (B, H, KV, S, D, Dv), q_mul, _ = CASES[name]
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((B, H, S, D), (B, KV, S, D), (B, KV, S, Dv),
                      (B, H, S, Dv))]
    arrs[0] *= q_mul
    return arrs


def jax_oracle(arrs, kw):
    """o and (dq, dk, dv) of the JAX package's reference in fp32."""
    jq, jk, jv, jct = (jnp.asarray(a) for a in arrs)

    def loss(q, k, v):
        o = jax_ref(q, k, v, **kw)
        return jnp.sum(o * jct), o
    (_, o), g = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jq, jk, jv)
    return np.asarray(o), [np.asarray(x) for x in g]


def f64_oracle(arrs, kw):
    """o and (dq, dk, dv) of the port's plain forward in float64, by
    autograd."""
    leaves = [torch.from_numpy(a).double().requires_grad_(True)
              for a in arrs[:3]]
    o = ref.attention_reference(*leaves, **kw)
    grads = torch.autograd.grad((o * torch.from_numpy(arrs[3]).double())
                                .sum(), leaves)
    return o.detach().numpy(), [g.numpy() for g in grads]


def mirror(arrs, kw, products):
    """o and (dq, dk, dv) of the split mirror (the backward fed the
    mirror's own o and lse, as the kernels feed theirs)."""
    q, k, v, ct = (torch.from_numpy(a) for a in arrs)
    o = ref.attention_split_reference(q, k, v, products=products, **kw)
    lse = ref.attention_lse_split_reference(q, k, products=products, **kw)
    grads = ref.attention_backward_split_reference(q, k, v, o, lse, ct,
                                                   products=products, **kw)
    return o.numpy(), [g.numpy() for g in grads]


def out_ok(got, want) -> bool:
    """check_flash's elementwise bound."""
    return bool(np.all(np.abs(got - want) <= FLASH_TOL
                       + FLASH_TOL * np.abs(want)))


def grad_errs(got, want):
    """max |got - want| over the largest |want|, each gradient."""
    return [float(np.abs(g - w).max() / np.abs(w).max())
            for g, w in zip(got, want)]


@pytest.fixture(scope="module")
def oracles():
    """Each case's draw and both oracles, computed once."""
    out = {}
    for name, (_, _, kw) in CASES.items():
        arrs = draw(name)
        out[name] = (arrs, jax_oracle(arrs, kw), f64_oracle(arrs, kw))
    return out


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("oracle", ["jax", "float64"])
def test_split_mirror_meets_the_fp32_tolerance(oracles, name, oracle):
    arrs, jax_out, f64_out = oracles[name]
    want_o, want_g = jax_out if oracle == "jax" else f64_out
    kw = CASES[name][2]
    o, grads = mirror(arrs, kw, products=3)
    assert out_ok(o, want_o), float(np.abs(o - want_o).max())
    errs = grad_errs(grads, want_g)
    assert max(errs) <= FLASH_TOL, errs


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("oracle", ["jax", "float64"])
def test_one_tf32_product_misses_the_fp32_tolerance(oracles, name, oracle):
    """The check's teeth: without the split, the output or a gradient
    leaves the bound."""
    arrs, jax_out, f64_out = oracles[name]
    want_o, want_g = jax_out if oracle == "jax" else f64_out
    o, grads = mirror(arrs, CASES[name][2], products=1)
    assert not out_ok(o, want_o) or max(grad_errs(grads, want_g)) > FLASH_TOL


def test_tf32_rounding_is_cvt_rna():
    """Round to nearest with ties away from zero at 10 mantissa bits;
    hi + lo recovers all but the last two of fp32's bits."""
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -11,
                      -(1 + 2 ** -11), 1 + 2 ** -11 - 2 ** -23, 0.0, -0.0,
                      3e-39], dtype=torch.float32)
    want = [1.0, 1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10), 1.0, 0.0, -0.0,
            None]
    got = ref.tf32_round(x)
    for g, w in zip(got.tolist()[:7], want[:7]):
        assert g == w
    assert got.view(torch.int32)[6] == x.view(torch.int32)[6]     # -0 kept
    assert bool((got.view(torch.int32) & 0x1FFF == 0).all())
    y = torch.from_numpy(np.random.default_rng(0).normal(size=4096)
                         .astype(np.float32))
    hi, lo = ref.split_tf32(y)
    assert bool((hi.view(torch.int32) & 0x1FFF == 0).all())
    assert bool((lo.view(torch.int32) & 0x1FFF == 0).all())
    err = ((hi.double() + lo.double()) - y.double()).abs() / y.double().abs()
    assert float(err.max()) <= 2.0 ** -21
    one = (ref.tf32_round(y).double() - y.double()).abs() / y.double().abs()
    assert float(one.max()) > 2.0 ** -13


def test_split_products_are_exact_and_refuse_other_inputs():
    """Each TF32 product is exact in fp32 (11 bits by 11), so the split's
    only roundings are its sums; it takes fp32 and 1 or 3 products."""
    rng = np.random.default_rng(1)
    a, b = (torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))
            for _ in range(2))
    ah, bh = ref.tf32_round(a), ref.tf32_round(b)
    assert torch.equal((ah[:, :1] * bh[:1, :]).double(),
                       ah[:, :1].double() * bh[:1, :].double())
    exact = a.double() @ b.double()
    three = ref.split_einsum("ik,kj->ij", a, b).double()
    one = ref.split_einsum("ik,kj->ij", a, b, products=1).double()
    assert float((three - exact).abs().max()) < \
        float((one - exact).abs().max()) / 100
    with pytest.raises(ValueError):
        ref.split_einsum("ik,kj->ij", a, b, products=2)
    with pytest.raises(TypeError):
        ref.attention_split_reference(*(torch.zeros(1, 1, 4, 8,
                                                    dtype=torch.bfloat16),) * 3)
