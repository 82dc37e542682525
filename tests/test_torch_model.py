"""The port's model stack against the JAX package's, on the CPU: the
Mamba2 mixer and its causal conv, ``serve_step`` prefill and decode on
reduced mamba2-130m (2 layers, fp32), parameter specs and counts, and the
numpy round trip of params.  JAX params reach the port through
``params_from_numpy``; inputs come from numpy seeds.

Tolerances are those of tests/test_arch_smoke.py: 2e-4 for prefill
logits, 2e-3 for decode; greedy tokens must be equal.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCH_NAMES, get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import convert, layers as TL, model as TM
from repro_torch.tree import leaf_paths

PREFILL_TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)


def configs(n_layers=2):
    return (replace(jax_reduced("mamba2-130m"), n_layers=n_layers),
            replace(reduced_config("mamba2-130m"), n_layers=n_layers))


def jax_and_port_params(seed=0, n_layers=2, scan_dominated=False):
    """JAX-initialised params and their port copy.  ``scan_dominated``
    puts the conv weights at 1/sqrt(width) and drops the D skip, so that
    each mixer's output is carried by its SSD scan (at the init's 0.02
    scale it is almost all the 4-token conv)."""
    jcfg, tcfg = configs(n_layers)
    jparams = JM.init_params(jax.random.key(seed), jcfg)
    tree = jax.tree_util.tree_map(np.array, jparams)
    if scan_dominated:
        ssm = tree["blocks"]["l0"]["ssm"]
        ssm["conv_w"] = ssm["conv_w"] * np.float32(25.0)
        ssm["D_skip"] = np.zeros_like(ssm["D_skip"])
        jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, tcfg, jparams, convert.params_from_numpy(tree, device="cpu")


def np_(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 12, 10)).astype(np.float32)
    w = rng.normal(size=(4, 10)).astype(np.float32)
    b = rng.normal(size=(10,)).astype(np.float32)
    state = rng.normal(size=(2, 3, 10)).astype(np.float32)
    for st in (None, state):
        got, gst = TL._causal_conv(*(torch.from_numpy(a) for a in (x, w, b)),
                                   None if st is None else torch.from_numpy(st))
        want, wst = JL._causal_conv(*(jnp.asarray(a) for a in (x, w, b)),
                                    None if st is None else jnp.asarray(st))
        np.testing.assert_allclose(np_(got), np_(want), **PREFILL_TOL)
        np.testing.assert_allclose(np_(gst), np_(wst), rtol=0, atol=0)


@pytest.mark.parametrize("seq,with_cache", [(64, False), (64, True), (1, True)])
def test_ssm_mixer_matches_jax(seq, with_cache):
    jcfg, tcfg, jparams, tparams = jax_and_port_params(seed=3)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["l0"]["ssm"])
    tp = {k: v[0] for k, v in tparams["blocks"]["l0"]["ssm"].items()}
    rng = np.random.default_rng(seq)
    x = rng.normal(size=(2, seq, jcfg.d_model)).astype(np.float32)
    jcache = tcache = None
    if with_cache:
        spec = JL.ssm_cache_spec(jcfg, 2)
        conv = rng.normal(size=spec["conv"].shape).astype(np.float32)
        state = rng.normal(size=spec["state"].shape).astype(np.float32)
        jcache = {"conv": jnp.asarray(conv), "state": jnp.asarray(state)}
        tcache = {"conv": torch.from_numpy(conv),
                  "state": torch.from_numpy(state)}
    got, gc = TL.ssm_mixer(torch.from_numpy(x), tp, tcfg, cache=tcache)
    want, wc = JL.ssm_mixer(jnp.asarray(x), jp, jcfg, cache=jcache)
    np.testing.assert_allclose(np_(got), np_(want), **PREFILL_TOL)
    if with_cache:
        for k in ("conv", "state"):
            np.testing.assert_allclose(np_(gc[k]), np_(wc[k]), **PREFILL_TOL)
    else:
        assert gc is None and wc is None


@pytest.mark.parametrize("scan_dominated", [False, True],
                         ids=["init", "scan-dominated"])
def test_serve_step_prefill_and_decode_match_jax(scan_dominated):
    """Whole-sequence forward, prefill of the first half and 4
    teacher-forced decode steps, on both packages: logits allclose, greedy
    tokens equal, and decode consistent with the whole-sequence logits."""
    jcfg, tcfg, jparams, tparams = jax_and_port_params(
        seed=1, scan_dominated=scan_dominated)
    B, S = 2, 64
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, S))
    jt = lambda a: {"tokens": jnp.asarray(a, jnp.int32)}          # noqa: E731
    tt = lambda a: {"tokens": torch.from_numpy(np.asarray(a))}    # noqa: E731

    ref_j, _ = JM.serve_step(jparams, jcfg, jt(toks), None, None)
    ref_t, none = TM.serve_step(tparams, tcfg, tt(toks), None, None)
    assert none is None and tuple(ref_t.shape) == (B, S, jcfg.vocab_size)
    np.testing.assert_allclose(np_(ref_t), np_(ref_j), **PREFILL_TOL)

    half = S // 2
    jc = JM.init_cache(jcfg, B, S)
    tc = TM.init_cache(tcfg, B, S, device="cpu")
    lj, jc = JM.serve_step(jparams, jcfg, jt(toks[:, :half]), jc, jnp.int32(0))
    lt, tc = TM.serve_step(tparams, tcfg, tt(toks[:, :half]), tc, 0)
    np.testing.assert_allclose(np_(lt), np_(lj), **PREFILL_TOL)
    np.testing.assert_allclose(np_(lt), np_(ref_t[:, :half]), **PREFILL_TOL)
    for k in ("conv", "state"):
        np.testing.assert_allclose(np_(tc["blocks"]["l0"][k]),
                                   np_(jc["blocks"]["l0"][k]), **PREFILL_TOL)
    assert np.array_equal(lt[:, -1].argmax(-1).numpy(),
                          np.asarray(lj[:, -1]).argmax(-1))
    for j in range(4):
        tok = toks[:, half + j:half + j + 1]
        lj, jc = JM.serve_step(jparams, jcfg, jt(tok), jc,
                               jnp.int32(half + j))
        lt, tc = TM.serve_step(tparams, tcfg, tt(tok), tc, half + j)
        np.testing.assert_allclose(np_(lt), np_(lj), **DECODE_TOL)
        np.testing.assert_allclose(np_(lt[:, 0]), np_(ref_t[:, half + j]),
                                   **DECODE_TOL)
        assert np.array_equal(lt[:, 0].argmax(-1).numpy(),
                              np.asarray(lj[:, 0]).argmax(-1))


def test_prefill_goes_through_the_ssd_route_once_per_layer():
    """On the CPU the scan takes the plain version: the kernel's count
    does not move, and every layer's prefill returns a state."""
    _, tcfg, _, tparams = jax_and_port_params(seed=2)
    before = ssd_scan.LAUNCHES
    toks = torch.zeros((1, 32), dtype=torch.int64)
    _, cache = TM.serve_step(tparams, tcfg, {"tokens": toks},
                             TM.init_cache(tcfg, 1, 32, device="cpu"), 0)
    assert ssd_scan.LAUNCHES == before
    assert tuple(cache["blocks"]["l0"]["state"].shape)[:2] == (2, 1)


def test_cast_params_keeps_bf16_serving_bitwise():
    """Casting once at load changes nothing the forward computes: bf16
    prefill and decode logits on ``cast_params(p)`` are bitwise those on
    ``p``, and each layer's vectors (A_log, dt_bias, D_skip, the conv
    bias, the norm gains) stay fp32, as the JAX package's per-layer cast
    keeps them."""
    _, tcfg, _, tparams = jax_and_port_params(seed=4, scan_dominated=True)
    cfg = replace(tcfg, compute_dtype="bfloat16")
    cast = TM.cast_params(tparams, cfg)
    for name, leaf in leaf_paths(cast):
        per_layer = leaf.dim() - int(name.startswith("['blocks']"))
        assert leaf.dtype == (torch.bfloat16 if per_layer >= 2
                              else torch.float32), name
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 36)))
    caches = [TM.init_cache(cfg, 2, 36, device="cpu") for _ in range(2)]
    for j, (lo, hi) in enumerate([(0, 32), (32, 33), (33, 34), (34, 35)]):
        got, caches[0] = TM.serve_step(cast, cfg, {"tokens": toks[:, lo:hi]},
                                       caches[0], lo)
        want, caches[1] = TM.serve_step(tparams, cfg,
                                        {"tokens": toks[:, lo:hi]},
                                        caches[1], lo)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, want), f"step {j}"


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_specs_and_counts_match_jax(name):
    jspecs = JM.param_specs(jax_get_config(name))
    tspecs = TM.param_specs(get_config(name))
    jflat = [(jax.tree_util.keystr(p), tuple(s.shape), str(s.dtype))
             for p, s in jax.tree_util.tree_flatten_with_path(jspecs)[0]]
    tflat = [(p, tuple(s.shape), str(s.dtype).replace("torch.", ""))
             for p, s in leaf_paths(tspecs)]
    assert tflat == jflat
    assert get_config(name).param_count() == \
        jax_get_config(name).param_count()
    assert get_config(name).active_param_count() == \
        jax_get_config(name).active_param_count()


def test_reduced_configs_match_jax():
    for name in ARCH_NAMES:
        assert reduced_config(name) == replace(
            reduced_config(name), **vars(jax_reduced(name)))


def test_init_params_follows_specs_and_distributions():
    cfg = reduced_config("mamba2-130m")
    gen = torch.Generator().manual_seed(0)
    params = TM.init_params(cfg, gen, device="cpu")
    specs = dict(leaf_paths(TM.param_specs(cfg)))
    for name, leaf in leaf_paths(params):
        assert tuple(leaf.shape) == specs[name].shape
        assert leaf.dtype == specs[name].dtype
    ssm = params["blocks"]["l0"]["ssm"]
    assert torch.all((ssm["A_log"] >= 0) & (ssm["A_log"] <= np.log(16.0)))
    assert torch.all(torch.nn.functional.softplus(ssm["dt_bias"]) < 0.1001)
    assert torch.equal(ssm["D_skip"], torch.ones_like(ssm["D_skip"]))
    assert not params["final_norm"]["w"].any()
    again = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(leaf_paths(params), leaf_paths(again)))


def test_numpy_round_trip_of_params():
    jcfg, tcfg, jparams, tparams = jax_and_port_params(seed=4)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    back = convert.params_to_numpy(convert.params_from_numpy(tree,
                                                             device="cpu"))
    jl = jax.tree_util.tree_leaves(tree)
    bl = jax.tree_util.tree_leaves(back)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(back)
    for a, b in zip(jl, bl):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    bf = {"w": np.asarray(jnp.asarray([[1.5, -2.25]], jnp.bfloat16))}
    t = convert.params_from_numpy(bf, device="cpu")
    assert t["w"].dtype == torch.bfloat16
    assert convert.params_to_numpy(t)["w"].tobytes() == bf["w"].tobytes()


def test_entry_points_default_to_the_card_and_other_archs_raise():
    cfg = reduced_config("mamba2-130m")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TM.init_params(cfg, torch.Generator())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TM.init_cache(cfg, 1, 8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            convert.params_from_numpy({"w": np.zeros(2, np.float32)})
        with pytest.raises(RuntimeError, match="no CUDA device"):
            convert.tensor_from_numpy(np.zeros(2, np.float32))
    # MLA and MoE configs, which raised before their layers were ported,
    # now serve on the CPU when asked to
    for name in ("deepseek-v3-671b", "moonshot-v1-16b-a3b"):
        cfg = reduced_config(name)
        params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
        logits, _ = TM.serve_step(params, cfg, {"tokens": torch.zeros(
            (1, 4), dtype=torch.int64)}, None, None)
        assert tuple(logits.shape) == (1, 4, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all())
    cfg = reduced_config("deepseek-v3-671b")
    cache = TM.init_cache(cfg, 1, 8, device="cpu")
    assert tuple(cache["dense0"]["latent"].shape) == \
        (1, 8, cfg.kv_lora_rank + cfg.qk_rope_dim)


def test_serve_launcher_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "mamba2-130m", "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "64", "--gen", "3"])
    out = capsys.readouterr().out
    assert "[serve] mamba2-130m on cpu: prefill 2x64" in out
    assert "decoded 2 steps" in out
    with pytest.raises(ValueError, match="multiple"):
        serve.main(["--arch", "mamba2-130m", "--device", "cpu",
                    "--prompt-len", "300"])
    # jamba (SSM + attention + MoE) serves; hubert runs its whole-sequence
    # forward and still refuses to decode
    serve.main(["--arch", "jamba-1.5-large-398b", "--reduced",
                "--device", "cpu", "--batch", "1", "--prompt-len", "32",
                "--gen", "2"])
    serve.main(["--arch", "hubert-xlarge", "--reduced", "--device", "cpu",
                "--batch", "1", "--prompt-len", "16"])
    out = capsys.readouterr().out
    assert "[serve] jamba-1.5-large-398b on cpu: prefill 1x32" in out
    assert "[serve] hubert-xlarge on cpu: forward 1x16 frames" in out
    with pytest.raises(ValueError, match="encoder-only"):
        serve.check_servable(reduced_config("hubert-xlarge"), 16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--arch", "mamba2-130m", "--reduced"])


def test_generate_matches_stepwise_serving():
    """``serve.generate``'s greedy tokens are those of prefill + decode
    steps driven by hand, and its prefill logits those of serve_step."""
    from repro_torch.launch import serve
    _, tcfg, _, tparams = jax_and_port_params(seed=5)
    prompts = torch.from_numpy(np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (2, 32)))
    out = serve.generate(tparams, tcfg, prompts, 4)
    cache = TM.init_cache(tcfg, 2, 36, device="cpu")
    logits, cache = TM.serve_step(tparams, tcfg, {"tokens": prompts}, cache, 0)
    assert torch.equal(out.prefill_logits, logits)
    toks = [logits[:, -1:].argmax(-1)]
    for j in range(3):
        step, cache = TM.serve_step(tparams, tcfg, {"tokens": toks[-1]},
                                    cache, 32 + j)
        toks.append(step[:, -1:].argmax(-1))
    assert torch.equal(out.tokens, torch.cat(toks, dim=1))
    assert out.decode_steps == 3
