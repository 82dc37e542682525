"""The port's mixture of experts against the JAX package's, on the CPU:
``moe_ffn`` (router in fp32, softmax, top-k with renormalised gates, the
sort-based capacity dispatch, batched expert SwiGLU, the combine, shared
experts, the switch auxiliary loss) on reduced moonshot-v1-16b-a3b (8
experts, top-3, no shared expert) and reduced deepseek-v3 (8 experts,
top-3, one shared expert), each at the dropless capacity factor 8.0 and at
a dropping 1.0; and a router with planted ties, where which expert a token
gets and which tokens overflow a bucket depend on the tie order of top-k
and on a stable sort.  Inputs and params come from numpy seeds.

Tolerance 1e-5 (the MLP's in tests/test_torch_dense.py: the same fp32
products, summed in another order).
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from repro.configs import reduced_config as jax_reduced
from repro.models import layers as JL
from repro_torch.configs import reduced_config
from repro_torch.models import layers as TL

MOE_TOL = dict(atol=1e-5, rtol=1e-5)


def np_(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


def moe_setup(name, capacity_factor, seed):
    jcfg = replace(jax_reduced(name), capacity_factor=capacity_factor)
    tcfg = replace(reduced_config(name), capacity_factor=capacity_factor)
    rng = np.random.default_rng(seed)

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(v) for k, v in node.items()}
        return (rng.normal(size=node) * 0.2).astype(np.float32)
    p = draw(TL.moe_params_shapes(tcfg))
    return jcfg, tcfg, p


def run_both(jcfg, tcfg, p, x):
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = jax.tree_util.tree_map(torch.from_numpy, p)
    y, aux = TL.moe_ffn(torch.from_numpy(x), tp, tcfg)
    jy, jaux = JL.moe_ffn(jnp.asarray(x), jp, jcfg)
    return (y, aux), (jy, jaux)


def dropped(cfg, probs: np.ndarray) -> int:
    """(token, expert) pairs past their bucket's capacity, from the router
    probabilities as the JAX package ranks them."""
    T = probs.shape[0]
    K, E = cfg.experts_per_token, cfg.n_experts
    gidx = np.asarray(lax.top_k(jnp.asarray(probs), K)[1]).reshape(-1)
    C = max(1, int(np.ceil(T * K / E * cfg.capacity_factor)))
    return int(np.maximum(np.bincount(gidx, minlength=E) - C, 0).sum())


@pytest.mark.parametrize("capacity_factor", [8.0, 1.0],
                         ids=["dropless", "dropping"])
@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b", "deepseek-v3-671b"],
                         ids=["moonshot", "deepseek-shared"])
def test_moe_ffn_matches_jax(name, capacity_factor):
    jcfg, tcfg, p = moe_setup(name, capacity_factor, seed=1)
    assert bool(tcfg.n_shared_experts) == (name == "deepseek-v3-671b")
    x = np.random.default_rng(2).normal(
        size=(2, 48, tcfg.d_model)).astype(np.float32)
    (y, aux), (jy, jaux) = run_both(jcfg, tcfg, p, x)
    assert tuple(y.shape) == x.shape and aux.dtype == torch.float32
    np.testing.assert_allclose(np_(y), np_(jy), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **MOE_TOL)
    probs = jax.nn.softmax(jnp.asarray(x.reshape(-1, tcfg.d_model))
                           @ jnp.asarray(p["router"]), axis=-1)
    n_drop = dropped(tcfg, np.asarray(probs))
    assert (n_drop == 0) == (capacity_factor == 8.0), n_drop


def test_top_k_breaks_ties_as_lax_top_k():
    """Lower index first among equal values, as ``lax.top_k``."""
    probs = np.array([[0.1, 0.3, 0.3, 0.3, 0.0],
                      [0.2, 0.2, 0.2, 0.2, 0.2],
                      [0.0, 0.5, 0.1, 0.5, 0.1]], np.float32)
    for k in (1, 2, 3, 4):
        vals, idx = TL.top_k(torch.from_numpy(probs), k)
        jvals, jidx = lax.top_k(jnp.asarray(probs), k)
        assert np.array_equal(idx.numpy(), np.asarray(jidx)), k
        assert np.array_equal(vals.numpy(), np.asarray(jvals)), k


def test_moe_ffn_with_tied_experts_overflowing_their_capacity():
    """Experts 5 and 6 have identical router columns, and a constant input
    feature makes experts 0 and 1 every token's first two choices, so the
    third choice is a tie between 5 and 6 at every token: lax.top_k takes
    5.  Experts 0, 1 and 5 then receive all 96 tokens each against a
    capacity of 36; which 36 they keep is the stable sort's (the earliest
    tokens).  Small integers and eighths keep the router's products and
    sums exact, so the tie is exact on both sides."""
    name = "moonshot-v1-16b-a3b"
    jcfg, tcfg, p = moe_setup(name, 1.0, seed=3)
    rng = np.random.default_rng(4)
    D, E = tcfg.d_model, tcfg.n_experts
    x = rng.integers(-2, 3, size=(2, 48, D)).astype(np.float32)
    x[..., 0] = 4.0
    router = rng.integers(-1, 2, size=(D, E)).astype(np.float32) / 8
    router[0, :] = [8.0, 7.0, 0.0, 0.0, 0.0, 5.0, 5.0, 0.0]
    router[:, 6] = router[:, 5]
    p["router"] = router
    logits = x.reshape(-1, D) @ router
    assert np.array_equal(logits[:, 5], logits[:, 6])
    probs = torch.softmax(torch.from_numpy(logits), dim=-1)
    assert torch.equal(probs[:, 5], probs[:, 6])
    _, idx = TL.top_k(probs, tcfg.experts_per_token)
    assert (idx[:, :2].sort(-1).values == torch.tensor([0, 1])).all() and \
        (idx[:, 2] == 5).all()
    assert dropped(tcfg, probs.numpy()) == 3 * (96 - 36)
    (y, aux), (jy, jaux) = run_both(jcfg, tcfg, p, x)
    np.testing.assert_allclose(np_(y), np_(jy), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **MOE_TOL)
    # had expert 6 taken the tie, or the sort not kept the earliest tokens,
    # the result would differ: the last token's third expert was dropped
    p6 = dict(p, router=np.concatenate(
        [router[:, :5], router[:, 5:6] - 1e-3, router[:, 6:]], axis=1))
    (y6, _), _ = run_both(jcfg, tcfg, p6, x)
    assert not np.allclose(np_(y6), np_(y), **MOE_TOL)
