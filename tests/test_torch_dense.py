"""The port's dense model stack against the JAX package's, on the CPU: the
MLP (gated and 2-matrix, gelu and silu, with and without biases) and
``serve_step`` prefill and decode for the reduced qwen2-7b,
starcoder2-3b, gemma2-9b and command-r-35b configs (2 layers, fp32), on
params the JAX package initialised, carried over by
``params_from_numpy``; then teacher-forced decode against the port's own
prefill, the in-place cache, and the serving launcher.

Tolerances are those of tests/test_arch_smoke.py: 2e-4 for prefill
logits, 2e-3 for decode; greedy tokens must be equal.  The MLP is held
to 1e-5 (the same fp32 products, summed in another order).
"""

from dataclasses import replace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from repro.configs import reduced_config as jax_reduced
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import ARCH_NAMES, get_config, reduced_config
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.models import convert, layers as TL, model as TM

PREFILL_TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
MLP_TOL = dict(rtol=1e-5, atol=1e-5)
DENSE = ["qwen2-7b", "starcoder2-3b", "gemma2-9b", "command-r-35b"]


def np_(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


def jax_and_port_params(name, seed):
    """Reduced config of both packages, JAX-initialised params and their
    port copy on the CPU."""
    jcfg, tcfg = jax_reduced(name), reduced_config(name)
    jparams = JM.init_params(jax.random.key(seed), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, convert.params_from_numpy(tree, device="cpu")


# ---------------------------------- MLP ---------------------------------- #

@pytest.mark.parametrize("gated,act,bias", [(True, "silu", False),
                                            (True, "gelu", False),
                                            (False, "gelu", True),
                                            (False, "silu", True)],
                         ids=["gated-silu", "gated-gelu", "plain-gelu-bias",
                              "plain-silu-bias"])
def test_mlp_matches_jax(gated, act, bias):
    base = reduced_config("qwen2-7b")
    tcfg = replace(base, gated_mlp=gated, mlp_act=act, mlp_bias=bias)
    jcfg = replace(jax_reduced("qwen2-7b"), gated_mlp=gated, mlp_act=act,
                   mlp_bias=bias)
    rng = np.random.default_rng(int(gated) * 2 + int(bias))
    p = {k: rng.normal(size=s).astype(np.float32) * 0.1
         for k, s in TL.mlp_params_shapes(tcfg, tcfg.d_ff).items()}
    x = rng.normal(size=(2, 24, tcfg.d_model)).astype(np.float32)
    got = TL.mlp(torch.from_numpy(x), {k: torch.from_numpy(v)
                                       for k, v in p.items()}, tcfg)
    want = JL.mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                  jcfg)
    np.testing.assert_allclose(np_(got), np_(want), **MLP_TOL)


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to the tanh form and torch's gelu to the exact
    erf form; they differ by up to ~5e-4 near |x| = 2.  The port's _act
    must be JAX's."""
    x = np.linspace(-6, 6, 4001, dtype=np.float32)
    got = TL._act(torch.from_numpy(x), "gelu")
    want = np.asarray(JL._act(jnp.asarray(x), "gelu"))
    np.testing.assert_allclose(np_(got), want, atol=1e-6, rtol=1e-6)
    exact = F.gelu(torch.from_numpy(x))              # torch's default
    assert float(np.abs(np_(exact) - want).max()) > 1e-4


def test_mixed_dtypes_promote_as_jax_does():
    """A bf16 weight against an fp32 activation (starcoder2's residual turns
    fp32 after its fp32 output bias): the product is fp32 on both sides."""
    x = np.random.default_rng(0).normal(size=(2, 5, 8)).astype(np.float32)
    w = np.random.default_rng(1).normal(size=(8, 6)).astype(np.float32)
    got = TL._mm(torch.from_numpy(x), torch.from_numpy(w).bfloat16())
    want = jnp.einsum("bsd,df->bsf", jnp.asarray(x),
                      jnp.asarray(w, jnp.bfloat16))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(np_(got), np_(want), **MLP_TOL)


# ------------------------------- serve_step ------------------------------- #

@pytest.mark.parametrize("name", DENSE)
def test_serve_step_prefill_and_decode_match_jax(name):
    """Whole-sequence forward (window active: reduced gemma2's window is 64
    of 96 tokens), prefill of 80 tokens into the cache and 4 decode steps,
    on both packages: logits allclose, greedy tokens equal."""
    jcfg, tcfg, jparams, tparams = jax_and_port_params(name, seed=1)
    B, S, half = 2, 96, 80
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, S))
    jt = lambda a: {"tokens": jnp.asarray(a, jnp.int32)}          # noqa: E731
    tt = lambda a: {"tokens": torch.from_numpy(np.asarray(a))}    # noqa: E731

    ref_j, _ = JM.serve_step(jparams, jcfg, jt(toks), None, None)
    ref_t, none = TM.serve_step(tparams, tcfg, tt(toks), None, None)
    assert none is None and tuple(ref_t.shape) == (B, S, jcfg.vocab_size)
    np.testing.assert_allclose(np_(ref_t), np_(ref_j), **PREFILL_TOL)

    jc = JM.init_cache(jcfg, B, S)
    tc = TM.init_cache(tcfg, B, S, device="cpu")
    lj, jc = JM.serve_step(jparams, jcfg, jt(toks[:, :half]), jc,
                           jnp.int32(0))
    lt, tc = TM.serve_step(tparams, tcfg, tt(toks[:, :half]), tc, 0)
    np.testing.assert_allclose(np_(lt), np_(lj), **PREFILL_TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(np_(tc["blocks"]["l0"][k]),
                                   np_(jc["blocks"]["l0"][k]), **PREFILL_TOL)
    for j in range(4):
        tok = toks[:, half + j:half + j + 1]
        lj, jc = JM.serve_step(jparams, jcfg, jt(tok), jc,
                               jnp.int32(half + j))
        lt, tc = TM.serve_step(tparams, tcfg, tt(tok), tc, half + j)
        np.testing.assert_allclose(np_(lt), np_(lj), **DECODE_TOL)
        assert np.array_equal(lt[:, 0].argmax(-1).numpy(),
                              np.asarray(lj[:, 0]).argmax(-1))


@pytest.mark.parametrize("name", DENSE)
def test_teacher_forced_decode_reproduces_prefill(name):
    """tests/test_arch_smoke.py's check on the port alone: prefill the
    first half, decode the second half token by token, and match the
    whole-sequence logits.  At 96 tokens gemma2's decode steps see the
    window (64) cut their context."""
    _, tcfg, _, tparams = jax_and_port_params(name, seed=3)
    B, S = 2, 96
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (B, S)))
    full, _ = TM.serve_step(tparams, tcfg, {"tokens": toks}, None, None)
    half = S // 2
    cache = TM.init_cache(tcfg, B, S, device="cpu")
    logits, cache = TM.serve_step(tparams, tcfg, {"tokens": toks[:, :half]},
                                  cache, 0)
    np.testing.assert_allclose(np_(logits), np_(full[:, :half]),
                               **PREFILL_TOL)
    for j in range(half, S):
        step, cache = TM.serve_step(tparams, tcfg,
                                    {"tokens": toks[:, j:j + 1]}, cache, j)
        np.testing.assert_allclose(np_(step[:, 0]), np_(full[:, j]),
                                   **DECODE_TOL, err_msg=f"{name} step {j}")


def test_serve_step_writes_the_cache_in_place():
    """The port's serving cache is updated in place and returned: prefill
    fills positions [0, 40) of every layer's K/V, a decode step position
    40, and nothing else moves."""
    _, tcfg, _, tparams = jax_and_port_params("gemma2-9b", seed=4)
    cache = TM.init_cache(tcfg, 1, 48, device="cpu")
    k_before = cache["blocks"]["l1"]["k"]
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (1, 41)))
    _, out = TM.serve_step(tparams, tcfg, {"tokens": toks[:, :40]}, cache, 0)
    assert out is cache and out["blocks"]["l1"]["k"] is k_before
    filled = k_before.abs().sum(dim=(0, 1, 3, 4)) > 0      # per position
    assert filled[:40].all() and not filled[40:].any()
    TM.serve_step(tparams, tcfg, {"tokens": toks[:, 40:41]}, cache, 40)
    filled = k_before.abs().sum(dim=(0, 1, 3, 4)) > 0
    assert filled[:41].all() and not filled[41:].any()


def test_cpu_prefill_launches_no_kernel():
    _, tcfg, _, tparams = jax_and_port_params("gemma2-9b", seed=5)
    before = fa.LAUNCHES
    TM.serve_step(tparams, tcfg, {"tokens": torch.zeros((1, 16),
                                                        dtype=torch.int64)},
                  TM.init_cache(tcfg, 1, 16, device="cpu"), 0)
    assert fa.LAUNCHES == before


def test_params_from_numpy_carries_the_dense_bf16_leaves():
    """gemma2's params at their bf16 storage dtype reach the port bit for
    bit, leaf by leaf."""
    cfg = jax_reduced("gemma2-9b")
    jparams = JM.init_params(jax.random.key(6),
                             replace(cfg, param_dtype="bfloat16"))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    port = convert.params_from_numpy(tree, device="cpu")
    back = convert.params_to_numpy(port)
    n_bf16 = 0
    for a, t, b in zip(jax.tree_util.tree_leaves(tree),
                       jax.tree_util.tree_leaves(port),
                       jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        n_bf16 += t.dtype == torch.bfloat16
    assert n_bf16 >= 9              # embed, wq/wk/wv/wo, wi/wo of each layer


# ------------------------------- launcher ------------------------------- #

def test_check_servable_takes_the_dense_family_and_refuses_the_rest():
    """Every causal config decodes (the dense family, mamba2, and since the
    MLA, MoE and frontend layers were ported deepseek-v3, moonshot, jamba
    and llava-next); the encoder (hubert) refuses to decode."""
    served = 0
    for name in ARCH_NAMES:
        cfg = get_config(name)
        if not cfg.causal:
            with pytest.raises(ValueError, match="encoder-only"):
                serve.check_servable(cfg, 64)
            continue
        serve.check_servable(cfg, 4096)
        serve.check_servable(cfg, 64)
        served += 1
    assert served == len(ARCH_NAMES) - 1


def test_serve_launcher_serves_reduced_gemma2_on_the_cpu(capsys):
    serve.main(["--arch", "gemma2-9b", "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "72", "--gen", "3"])
    out = capsys.readouterr().out
    assert "[serve] gemma2-9b on cpu: prefill 2x72" in out
    assert "decoded 2 steps" in out
