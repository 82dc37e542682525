"""The port's multi-head latent attention (MLA, deepseek-v3) against the JAX
package's, on the CPU: ``mla_attention`` on reduced deepseek-v3 (4 heads,
q/k head dim 48 = qk_nope 32 + qk_rope 16, v head dim 32, latent 32 + 16)
without a cache, as a prefill into the latent cache, in absorbed decode
and in decode without absorption; and the attention it reaches with a
value head dim below the key head dim — the plain flash version and each
strategy of ``layers.attention`` — against the JAX package's.  Inputs and
params come from numpy seeds and reach both packages as the same arrays.

Tolerances: 2e-4 for the layer (tests/test_arch_smoke.py's prefill
tolerance: projections, norms and rotary tables add their own roundings),
2e-5 for attention alone (the same fp32 products summed in another order).
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs import reduced_config as jax_reduced
from repro.kernels.flash_attention.ref import attention_reference as jax_ref
from repro.models import layers as JL
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.models import layers as TL

LAYER_TOL = dict(atol=2e-4, rtol=2e-4)
FP32_TOL = dict(atol=2e-5, rtol=2e-5)
NAME = "deepseek-v3-671b"


def np_(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


def mla_setup(seed, absorb=True):
    """Reduced deepseek-v3 of both packages and one MLA layer's params
    (matrices at 0.2 · N(0, 1), norm gains at 0.1 · N(0, 1))."""
    jcfg = replace(jax_reduced(NAME), mla_absorb=absorb)
    tcfg = replace(reduced_config(NAME), mla_absorb=absorb)
    rng = np.random.default_rng(seed)
    p = {k: (rng.normal(size=s) * (0.1 if len(s) == 1 else 0.2)
             ).astype(np.float32)
         for k, s in TL.mla_params_shapes(tcfg).items()}
    return (jcfg, tcfg, {k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def x_draw(cfg, S, seed, B=2):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


def test_reduced_deepseek_has_a_value_head_below_the_key_head():
    cfg = reduced_config(NAME)
    assert (cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim) == (48, 32)
    full = get_config(NAME)
    assert (full.qk_nope_dim + full.qk_rope_dim, full.v_head_dim) == (192, 128)


def test_mla_attention_without_a_cache_matches_jax():
    jcfg, tcfg, jp, tp = mla_setup(1)
    x = x_draw(tcfg, 40, 2)
    got, none = TL.mla_attention(torch.from_numpy(x), tp, tcfg)
    want, _ = JL.mla_attention(jnp.asarray(x), jp, jcfg)
    assert none is None and tuple(got.shape) == x.shape
    np.testing.assert_allclose(np_(got), np_(want), **LAYER_TOL)


def latent_caches(jcfg, tcfg, B, T):
    spec = TL.mla_cache_spec(tcfg, B, T)
    jspec = JL.mla_cache_spec(jcfg, B, T)
    assert tuple(spec["latent"].shape) == tuple(jspec["latent"].shape) == \
        (B, T, tcfg.kv_lora_rank + tcfg.qk_rope_dim)
    return ({"latent": jnp.zeros(jspec["latent"].shape,
                                 jspec["latent"].dtype)},
            {"latent": torch.zeros(spec["latent"].shape,
                                   dtype=spec["latent"].dtype)})


def test_mla_prefill_fills_the_latent_cache_in_place():
    """A prefill of 24 tokens into a 32-slot cache: the output and the
    latent rows equal the JAX package's, the rows past 24 stay zero, and
    the port returns the cache tensor it was given."""
    jcfg, tcfg, jp, tp = mla_setup(3)
    x = x_draw(tcfg, 24, 4)
    jc, tc = latent_caches(jcfg, tcfg, 2, 32)
    lat = tc["latent"]
    got, tc2 = TL.mla_attention(torch.from_numpy(x), tp, tcfg, cache=tc,
                                index=0)
    want, jc = JL.mla_attention(jnp.asarray(x), jp, jcfg, cache=jc,
                                index=jnp.int32(0))
    assert tc2["latent"] is lat
    np.testing.assert_allclose(np_(got), np_(want), **LAYER_TOL)
    np.testing.assert_allclose(np_(lat), np_(jc["latent"]), **LAYER_TOL)
    assert not lat[:, 24:].any()


@pytest.mark.parametrize("absorb,steps", [(True, 4), (False, 2)],
                         ids=["absorbed", "not-absorbed"])
def test_mla_decode_matches_jax(absorb, steps):
    """Prefill of 24 tokens, then decode steps at 24, 25, ... against the
    latent cache: absorbed (wkv_b folded into the query and the output,
    attention in the latent space) or expanding the cache every step."""
    jcfg, tcfg, jp, tp = mla_setup(5, absorb)
    x = x_draw(tcfg, 24 + steps, 6)
    jc, tc = latent_caches(jcfg, tcfg, 2, 32)
    for lo, hi in [(0, 24)] + [(24 + j, 25 + j) for j in range(steps)]:
        got, tc = TL.mla_attention(torch.from_numpy(x[:, lo:hi]), tp, tcfg,
                                   cache=tc, index=lo)
        want, jc = JL.mla_attention(jnp.asarray(x[:, lo:hi]), jp, jcfg,
                                    cache=jc, index=jnp.int32(lo))
        np.testing.assert_allclose(np_(got), np_(want), **LAYER_TOL,
                                   err_msg=f"positions {lo}..{hi}")
        np.testing.assert_allclose(np_(tc["latent"]), np_(jc["latent"]),
                                   **LAYER_TOL)


def test_absorbed_decode_equals_the_expanded_one():
    """Folding wkv_b into the query and the output changes only the order
    of the products: on the port alone the two decodes agree."""
    _, tcfg, _, tp = mla_setup(7)
    x = torch.from_numpy(x_draw(tcfg, 20, 8))
    outs = {}
    for absorb in (True, False):
        cfg = replace(tcfg, mla_absorb=absorb)
        cache = {"latent": torch.zeros(TL.mla_cache_spec(cfg, 2, 20)
                                       ["latent"].shape)}
        TL.mla_attention(x[:, :16], tp, cfg, cache=cache, index=0)
        outs[absorb] = [TL.mla_attention(x[:, j:j + 1], tp, cfg, cache=cache,
                                         index=j)[0] for j in range(16, 20)]
    for a, b in zip(outs[True], outs[False]):
        np.testing.assert_allclose(np_(a), np_(b), **LAYER_TOL)


# ------------------ attention with Dv below D (MLA's prefill) ------------------ #

def draw(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("B,H,S,D,Dv,strategy", [
    (2, 4, 96, 48, 32, "direct"),
    (1, 2, 2560, 24, 16, "blockwise"),
], ids=["direct", "blockwise"])
def test_attention_with_a_narrower_value_head_matches_jax(B, H, S, D, Dv,
                                                          strategy):
    """The plain flash version (q [B,H,S,D], k [B,H,S,D], v [B,H,S,Dv] ->
    [B,H,S,Dv]) against the JAX package's, and ``layers.attention`` on
    MLA's layout ([B,S,H,1,D] against [B,S,H,D] and [B,S,H,Dv], heads as
    kv groups of one) against the JAX package's at a shape where its
    dispatch picks ``strategy``."""
    q, k, v = draw([(B, H, S, D), (B, H, S, D), (B, H, S, Dv)], S + D)
    scale = 1.0 / np.sqrt(D)
    got = ref.attention_reference(*map(torch.from_numpy, (q, k, v)),
                                  causal=True, scale=scale)
    assert tuple(got.shape) == (B, H, S, Dv)
    want = jax_ref(*map(jnp.asarray, (q, k, v)), causal=True, scale=scale)
    np.testing.assert_allclose(np_(got), np_(want), **FP32_TOL)
    before = fa.LAUNCHES
    routed = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=True, scale=scale)
    assert fa.LAUNCHES == before and torch.equal(routed, got)

    ql = q.transpose(0, 2, 1, 3)[:, :, :, None, :]         # [B,S,H,1,D]
    kl, vl = k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)
    layer = TL.attention(*map(torch.from_numpy, (ql, kl, vl)), causal=True,
                         scale=scale)
    assert tuple(layer.shape) == (B, S, H, 1, Dv)
    jlayer = JL.attention(*map(jnp.asarray, (ql, kl, vl)), causal=True,
                          scale=scale)
    np.testing.assert_allclose(np_(layer), np_(jlayer), **FP32_TOL)
    np.testing.assert_allclose(np_(layer[:, :, :, 0]).transpose(0, 2, 1, 3),
                               np_(got), **FP32_TOL)
    own = {"direct": lambda *a: TL._direct_attention(
               *a, scale=scale, causal=True, window=None, cap=None,
               q_offset=0, kv_len=None),
           "blockwise": lambda *a: TL._blockwise_attention(
               *a, scale=scale, causal=True, window=None, cap=None,
               q_offset=0, chunk_q=512)}[strategy]
    assert torch.equal(own(*map(torch.from_numpy, (ql, kl, vl))), layer)


def test_mla_and_hubert_prefills_take_the_cuda_core_plan():
    """In fp32 (the card-vs-CPU checks) MLA's prefill (D 192, Dv 128) and
    hubert's (D 80) take the mma.sync kernel's plan (the "cuda_cores"
    route) at the 192- and 128-wide instantiations, 32 and 64 keys a tile;
    so does bf16 at a head dim of 128 with Dv 64, a pair without a
    tensor-core instantiation."""
    full = get_config(NAME)
    D, Dv = full.qk_nope_dim + full.qk_rope_dim, full.v_head_dim
    hubert = get_config("hubert-xlarge").resolved_head_dim
    assert (D, Dv, hubert) == (192, 128, 80)
    plan = fa.tile_plan(torch.float32, D, Dv)
    assert plan.route == "cuda_cores" and plan.keys == 32
    assert plan.smem_bytes == (128 * 196 + 2 * 32 * (196 + 132)) * 4
    plan = fa.tile_plan(torch.float32, hubert)
    assert plan.route == "cuda_cores" and plan.keys == 64
    assert plan.smem_bytes == (128 * 84 + 2 * 64 * (84 + 84)) * 4
    assert fa.tile_plan(torch.bfloat16, 128, 64).route == "cuda_cores"


def test_mla_and_hubert_bf16_prefills_take_the_tensor_core_plan():
    """In bf16, as they serve, MLA's prefill (D 192, Dv 128) and hubert's
    (D 80) each have a tensor-core instantiation: Q·Kᵀ over three
    64-column boxes at 192 (214,144 B of shared memory), two boxes, the
    second zero past column 80, at 80 (the 160 KB of D 128's ring); a
    bf16 head dim of 128 with Dv 128 takes the tensor cores too."""
    full = get_config(NAME)
    D, Dv = full.qk_nope_dim + full.qk_rope_dim, full.v_head_dim
    hubert = get_config("hubert-xlarge").resolved_head_dim
    plan = fa.tile_plan(torch.bfloat16, D, Dv)
    assert (plan.route, plan.keys, plan.smem_bytes) == \
        ("tensor_cores", 128, 214144)
    plan = fa.tile_plan(torch.bfloat16, hubert)
    assert (plan.route, plan.keys, plan.smem_bytes) == \
        ("tensor_cores", 128, 160 * 1024 + 1024 + 128)
    assert fa.tile_plan(torch.bfloat16, 128, 128).route == "tensor_cores"
