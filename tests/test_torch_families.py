"""The port's model stack against the JAX package's for the families this
port serves beside the dense GQA and SSM ones, on the CPU: deepseek-v3
(MLA with its latent cache, a dense prologue layer, MoE with a shared
expert), moonshot (MoE), jamba (SSM + attention + MoE), llava-next (patch
embeddings before the tokens) and hubert (an encoder over frame
embeddings), each at its reduced config (fp32), on params the JAX
package initialised and carried over by ``params_from_numpy``.

Causal configs: the whole sequence, then a prefill into the cache and 4
decode steps, against the JAX package's ``serve_step``; then, on the port
alone, teacher-forced decode against its own whole-sequence logits.
hubert has no decode: its whole-sequence forward (``serve.forward``).
The reduced MoE configs are dropless (capacity factor = n_experts), so a
decode step routes as the whole sequence does.

Tolerances are those of tests/test_arch_smoke.py: 2e-4 for prefill
logits, 2e-3 for decode; greedy tokens must be equal.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import reduced_config as jax_reduced
from repro.models import model as JM
from repro_torch.configs import reduced_config
from repro_torch.launch import serve
from repro_torch.models import convert, model as TM

PREFILL_TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
FAMILIES = ["deepseek-v3-671b", "moonshot-v1-16b-a3b",
            "jamba-1.5-large-398b", "llava-next-34b", "hubert-xlarge"]
CAUSAL = FAMILIES[:-1]
PATCHES = 8                 # llava: patch positions before the tokens


def np_(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


def jax_and_port_params(name, seed):
    jcfg, tcfg = jax_reduced(name), reduced_config(name)
    jparams = JM.init_params(jax.random.key(seed), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, convert.params_from_numpy(tree, device="cpu")


def inputs(cfg, B, S, seed):
    """numpy inputs of S positions: frames, patches + tokens, or tokens."""
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "frames":
        return {"frames": rng.normal(size=(B, S, cfg.frontend_dim))
                .astype(np.float32)}
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    if cfg.input_kind == "tokens+patches":
        return {"patches": rng.normal(size=(B, PATCHES, cfg.frontend_dim))
                .astype(np.float32), "tokens": toks[:, PATCHES:]}
    return {"tokens": toks}


def as_jax(batch):
    return {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
            for k, v in batch.items()}


def as_port(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def head(batch, n):
    """The prompt's first n positions (patches first)."""
    out = dict(batch)
    if "patches" in batch:
        out["tokens"] = batch["tokens"][:, :n - PATCHES]
    else:
        out["tokens"] = batch["tokens"][:, :n]
    return out


def token_at(batch, j):
    """The token at absolute position j, [B, 1]."""
    off = PATCHES if "patches" in batch else 0
    return batch["tokens"][:, j - off:j - off + 1]


@pytest.mark.parametrize("name", FAMILIES)
def test_serve_step_matches_jax(name):
    """The whole sequence (S = 64: two of jamba's 32-token scan chunks), on
    both packages; for a causal config also a prefill of 32 positions
    into a 64-slot cache and 4 decode steps."""
    jcfg, tcfg, jparams, tparams = jax_and_port_params(name, seed=1)
    B, S, half = 2, 64, 32
    batch = inputs(tcfg, B, S, seed=2)
    if not tcfg.causal:
        ref_j, _ = JM.serve_step(jparams, jcfg, as_jax(batch), None, None)
        fwd = serve.forward(tparams, tcfg, as_port(batch))
        assert tuple(fwd.logits.shape) == (B, S, tcfg.vocab_size)
        np.testing.assert_allclose(np_(fwd.logits), np_(ref_j), **PREFILL_TOL)
        return
    ref_j, _ = JM.serve_step(jparams, jcfg, as_jax(batch), None, None)
    ref_t, none = TM.serve_step(tparams, tcfg, as_port(batch), None, None)
    assert none is None and tuple(ref_t.shape) == (B, S, tcfg.vocab_size)
    np.testing.assert_allclose(np_(ref_t), np_(ref_j), **PREFILL_TOL)

    jc = JM.init_cache(jcfg, B, S)
    tc = TM.init_cache(tcfg, B, S, device="cpu")
    lj, jc = JM.serve_step(jparams, jcfg, as_jax(head(batch, half)), jc,
                           jnp.int32(0))
    lt, tc = TM.serve_step(tparams, tcfg, as_port(head(batch, half)), tc, 0)
    np.testing.assert_allclose(np_(lt), np_(lj), **PREFILL_TOL)
    for j in range(half, half + 4):
        tok = token_at(batch, j)
        lj, jc = JM.serve_step(jparams, jcfg, as_jax({"tokens": tok}), jc,
                               jnp.int32(j))
        lt, tc = TM.serve_step(tparams, tcfg, as_port({"tokens": tok}), tc,
                               j)
        np.testing.assert_allclose(np_(lt), np_(lj), **DECODE_TOL,
                                   err_msg=f"{name} step {j}")
        assert np.array_equal(lt[:, 0].argmax(-1).numpy(),
                              np.asarray(lj[:, 0]).argmax(-1))


@pytest.mark.parametrize("name", CAUSAL)
def test_teacher_forced_decode_reproduces_the_whole_sequence(name):
    """tests/test_arch_smoke.py's check on the port alone: prefill the
    first 32 positions, decode the other 32 token by token, and match the
    whole-sequence logits."""
    _, tcfg, _, tparams = jax_and_port_params(name, seed=3)
    B, S, half = 2, 64, 32
    batch = as_port(inputs(tcfg, B, S, seed=3))
    full, _ = TM.serve_step(tparams, tcfg, batch, None, None)
    cache = TM.init_cache(tcfg, B, S, device="cpu")
    logits, cache = TM.serve_step(tparams, tcfg, head(batch, half), cache, 0)
    np.testing.assert_allclose(np_(logits), np_(full[:, :half]),
                               **PREFILL_TOL)
    for j in range(half, S):
        step, cache = TM.serve_step(tparams, tcfg,
                                    {"tokens": token_at(batch, j)}, cache, j)
        np.testing.assert_allclose(np_(step[:, 0]), np_(full[:, j]),
                                   **DECODE_TOL, err_msg=f"{name} step {j}")


def test_deepseek_caches_hold_the_latent_of_every_layer():
    """deepseek's serving state: one latent cache per dense prologue layer
    and per block layer ([B, T, kv_lora + qk_rope]), written in place by
    the prefill and returned as the same tensors."""
    _, tcfg, _, tparams = jax_and_port_params("deepseek-v3-671b", seed=4)
    width = tcfg.kv_lora_rank + tcfg.qk_rope_dim
    cache = TM.init_cache(tcfg, 1, 24, device="cpu")
    assert set(cache) == {"blocks", "dense0"}
    assert tuple(cache["dense0"]["latent"].shape) == (1, 24, width)
    assert tuple(cache["blocks"]["l0"]["latent"].shape) == \
        (tcfg.n_blocks, 1, 24, width)
    before = [cache["dense0"]["latent"], cache["blocks"]["l0"]["latent"]]
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (1, 20)))
    _, out = TM.serve_step(tparams, tcfg, {"tokens": toks}, cache, 0)
    assert out is cache
    for lat, now in zip(before, (out["dense0"]["latent"],
                                 out["blocks"]["l0"]["latent"])):
        assert lat is now
        filled = lat.reshape(-1, 24, width).abs().sum(dim=(0, 2)) > 0
        assert filled[:20].all() and not filled[20:].any()


def test_params_from_numpy_carries_the_mla_and_moe_bf16_leaves():
    """deepseek-v3's MLA and MoE params at their bf16 storage dtype reach
    the port bit for bit, leaf by leaf, and come back so."""
    cfg = replace(jax_reduced("deepseek-v3-671b"), param_dtype="bfloat16")
    tree = jax.tree_util.tree_map(np.asarray,
                                  JM.init_params(jax.random.key(6), cfg))
    port = convert.params_from_numpy(tree, device="cpu")
    back = convert.params_to_numpy(port)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    attn, ffn = port["blocks"]["l0"]["attn"], port["blocks"]["l0"]["ffn"]
    leaves = {**{k: attn[k] for k in ("wq_a", "wq_b", "wkv_a", "wkv_b",
                                      "wo_mla")},
              "router": ffn["router"], "experts/wi": ffn["experts"]["wi"],
              "experts/wo": ffn["experts"]["wo"],
              "shared/wi": ffn["shared"]["wi"],
              "shared/wo": ffn["shared"]["wo"]}
    src = tree["blocks"]["l0"]
    want = {**{k: src["attn"][k] for k in ("wq_a", "wq_b", "wkv_a", "wkv_b",
                                           "wo_mla")},
            "router": src["ffn"]["router"],
            "experts/wi": src["ffn"]["experts"]["wi"],
            "experts/wo": src["ffn"]["experts"]["wo"],
            "shared/wi": src["ffn"]["shared"]["wi"],
            "shared/wo": src["ffn"]["shared"]["wo"]}
    for k, t in leaves.items():
        assert t.dtype == torch.bfloat16, k
        assert convert.tensor_to_numpy(t).tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("name", FAMILIES)
def test_serve_launcher_serves_each_family_on_the_cpu(name, capsys):
    serve.main(["--arch", name, "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "32", "--gen", "3"])
    out = capsys.readouterr().out
    if name == "hubert-xlarge":
        assert "[serve] hubert-xlarge on cpu: forward 2x32 frames" in out
        assert f"(2, 32, {reduced_config(name).vocab_size})" in out
    else:
        assert f"[serve] {name} on cpu: prefill 2x32" in out
        assert "decoded 2 steps" in out


def test_generate_puts_the_patches_before_the_prompt():
    """llava's generate: the prefill sees patches + tokens (Np + P
    positions), and its greedy tokens are those of prefill + decode driven
    by hand from position Np + P."""
    _, tcfg, _, tparams = jax_and_port_params("llava-next-34b", seed=7)
    batch = as_port(inputs(tcfg, 2, 24, seed=7))
    out = serve.generate(tparams, tcfg, batch["tokens"], 3,
                         patches=batch["patches"])
    assert tuple(out.prefill_logits.shape) == (2, 24, tcfg.vocab_size)
    cache = TM.init_cache(tcfg, 2, 27, device="cpu")
    logits, cache = TM.serve_step(tparams, tcfg, batch, cache, 0)
    assert torch.equal(out.prefill_logits, logits)
    toks = [logits[:, -1:].argmax(-1)]
    for j in range(2):
        step, cache = TM.serve_step(tparams, tcfg, {"tokens": toks[-1]},
                                    cache, 24 + j)
        toks.append(step[:, -1:].argmax(-1))
    assert torch.equal(out.tokens, torch.cat(toks, dim=1))
    with pytest.raises(ValueError, match="encoder-only"):
        serve.generate(tparams, reduced_config("hubert-xlarge"),
                       batch["tokens"], 3)


@pytest.mark.parametrize("name,want", [
    ("deepseek-v3-671b", "[serving] deepseek-v3-671b: 2 seqs, prefill 16"),
    ("hubert-xlarge", "[serving] hubert-xlarge: encoder, 2 x 16 frames")])
def test_serving_example_runs_on_the_cpu(name, want):
    """examples/torch_serving.py, run as a user would with ``--device
    cpu``."""
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    res = subprocess.run(
        [sys.executable, str(root / "examples" / "torch_serving.py"),
         "--arch", name, "--device", "cpu", "--batch", "2",
         "--prompt-len", "16", "--gen", "3"], capture_output=True,
        text=True, timeout=120,
        env={"PYTHONPATH": str(root / "src"), "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr
    assert want in res.stdout
