"""The port's optimizer bounded in memory, against the JAX package's
``optim/optimizer.py``, on the CPU.

``_global_norm`` sums each grad leaf in pieces of ``PIECE`` elements, and
Adafactor updates a leaf in pieces of its leading axes in two passes (the
moments and Σu², then the update clipped by the whole leaf's RMS).  The
pieces change the order of the whole-leaf sums only, so each update is
held to the JAX package's at the tolerance of the existing Adafactor
parity (``tests/test_torch_train.py``: rtol 1e-6, atol 1e-6), with
``PIECE`` cut to force many pieces; the donated update is bitwise the
functional one.  A reduced qwen2-7b Adafactor train step is held to the
JAX step at ``forward_train``'s tolerances (loss 1e-5, each leaf 5e-5 of
its largest magnitude; param elements whose grad is round-off are not
compared), and the update from JAX's grads, given to both optimizers,
is held on every element.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticDataset as JDataset
from repro.models import model as JM
from repro.optim import OptConfig as JOptConfig
from repro.optim import optimizer as jopt
from repro.train.step import init_train_state as jax_init_train_state
from repro.train.step import train_step as jax_train_step
from repro_torch.configs import reduced_config
from repro_torch.models.convert import params_from_numpy, \
    train_state_from_numpy
from repro_torch.optim import OptConfig, apply_updates, init_opt_state
from repro_torch.optim import optimizer as topt
from repro_torch.train.step import apply_step, train_step
from repro_torch.tree import leaf_paths

# a stacked block leaf [n_blocks, rows, 2, cols] as qwen2's ffn.wi, a
# whole matrix, an unfactored stacked leaf (a dim of 1) and a vector
SHAPES = {"wi": (3, 8, 2, 16), "embed": (24, 16), "gate": (3, 1, 16),
          "norm": (16,)}
OPT = dict(name="adafactor", lr=1e-2, warmup_steps=2, decay_steps=50,
           clip_norm=0.5, clip_rms=0.5)


def jax_leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = {k: (rng.normal(size=s) * 0.05).astype(np.float32)
              for k, s in SHAPES.items()}
    # rows of other scales, so that pieces differ in their RMS
    grads = {k: (rng.normal(size=s) * rng.uniform(0.1, 3.0, size=s[:1] + (1,)
                                                   * (len(s) - 1)))
             .astype(np.float32) for k, s in SHAPES.items()}
    state = jax.tree_util.tree_map(
        lambda s: np.abs(rng.normal(size=s.shape)).astype(np.float32) * 1e-3,
        jax.tree_util.tree_map(np.asarray, jopt.init_opt_state(
            params, JOptConfig(**OPT))))
    return params, grads, state


def port(tree):
    return params_from_numpy(tree, "cpu")


def jax_update(params, grads, state, step):
    return jax.jit(jopt.apply_updates, static_argnums=4)(
        *(jax.tree_util.tree_map(jnp.asarray, t)
          for t in (params, grads, state)),
        jnp.asarray(step, jnp.int32), JOptConfig(**OPT))


@pytest.mark.parametrize("piece", [1, 40, 100, 1 << 26])
def test_pieces_of_adafactor_match_jax(monkeypatch, piece):
    """PIECE 1 and 40 take one row of the stacked leaf's 24 at a time, 100
    three rows (the last piece shorter), the default the whole leaf; the
    matrix and the vector are taken whole or in flat pieces."""
    monkeypatch.setattr(topt, "PIECE", piece)
    params, grads, state = inputs()
    jp, js, jm = jax_update(params, grads, state, 7)
    tp, ts, tm = apply_updates(port(params), port(grads), port(state),
                               torch.tensor(7, dtype=torch.int32),
                               OptConfig(**OPT))
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-6)
    for got, want in ((tp, jp), (ts, js)):
        g, w = dict(leaf_paths(got)), jax_leaves(want)
        assert g.keys() == w.keys()
        for n in w:
            np.testing.assert_allclose(g[n].numpy(), w[n], rtol=1e-6,
                                       atol=1e-6, err_msg=n)


def test_adafactor_pieces_split_the_leading_axes(monkeypatch):
    """The split of each leaf: the stacked leaf over its 24 leading rows,
    the matrix whole, the unfactored leaf over all its elements."""
    monkeypatch.setattr(topt, "PIECE", 40)
    t = {k: torch.zeros(s) for k, s in SHAPES.items()}
    assert topt._adafactor_split(t["wi"], True) == (2, 1)
    assert topt._adafactor_split(t["embed"], True) == (0, 1)
    assert topt._adafactor_split(t["gate"], False) == (3, 40)
    assert topt._adafactor_split(t["norm"], False) == (1, 40)
    assert [p.shape for p in topt._split(t["wi"], 2, 1)] == \
        [torch.Size([1, 2, 16])] * 24


def test_rms_clip_taken_per_piece_is_caught(monkeypatch):
    """The planted fault that chip_smoke.py plants on the card: the update's
    RMS taken over each piece instead of over the leaf moves the stacked
    leaf past the tolerance above."""
    monkeypatch.setattr(topt, "PIECE", 40)
    monkeypatch.setattr(topt, "_clip_rms", lambda sums, sizes: [
        torch.sqrt(s / n + 1e-30) for s, n in zip(sums, sizes)])
    params, grads, state = inputs()
    jp, _, _ = jax_update(params, grads, state, 7)
    tp, _, _ = apply_updates(port(params), port(grads), port(state),
                             torch.tensor(7, dtype=torch.int32),
                             OptConfig(**OPT))
    w = jax_leaves(jp)
    assert not np.allclose(tp["wi"].numpy(), w["['wi']"], rtol=1e-6,
                           atol=1e-6)


@pytest.mark.parametrize("piece", [1, 40])
def test_donated_adafactor_is_bitwise_the_functional_one(monkeypatch, piece):
    monkeypatch.setattr(topt, "PIECE", piece)
    params, grads, state = (port(t) for t in inputs(1))
    step = torch.tensor(3, dtype=torch.int32)
    want_p, want_s, want_m = apply_updates(params, grads, state, step,
                                           OptConfig(**OPT))
    ptrs = {n: t.data_ptr() for n, t in leaf_paths((params, state))}
    got_p, got_s, got_m = apply_updates(params, grads, state, step,
                                        OptConfig(**OPT), donate=True)
    assert {n: t.data_ptr() for n, t in leaf_paths((got_p, got_s))} == ptrs
    for (n, a), (_, b) in zip(leaf_paths((got_p, got_s)),
                              leaf_paths((want_p, want_s))):
        assert torch.equal(a, b), n
    assert torch.equal(got_m["grad_norm"], want_m["grad_norm"])


@pytest.mark.parametrize("piece", [7, 1 << 26])
def test_global_norm_matches_jax(monkeypatch, piece):
    """fp32 and bf16 leaves, each summed in fp32 over pieces."""
    monkeypatch.setattr(topt, "PIECE", piece)
    rng = np.random.default_rng(5)
    tree = {"a": rng.normal(size=(3, 8, 2, 16)).astype(np.float32),
            "b": rng.normal(size=(50,)).astype(ml_dtypes.bfloat16),
            "c": (rng.normal(size=(9, 7)) * 30).astype(np.float32)}
    want = float(jopt._global_norm(jax.tree_util.tree_map(jnp.asarray,
                                                          tree)))
    got = topt._global_norm(t for _, t in leaf_paths(port(tree)))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6)


def test_global_norm_copies_no_whole_leaf(monkeypatch):
    """No fp32 tensor larger than a piece is made while the norm is
    taken."""
    monkeypatch.setattr(topt, "PIECE", 64)
    leaf = torch.randn(4096, dtype=torch.bfloat16)
    seen = []
    real = torch.Tensor.to

    def to(self, *a, **kw):
        out = real(self, *a, **kw)
        seen.append(out.numel())
        return out
    monkeypatch.setattr(torch.Tensor, "to", to)
    topt._global_norm([leaf])
    assert seen and max(seen) == 64


def test_reduced_qwen2_adafactor_step_matches_jax(monkeypatch):
    """One journaled Adafactor step of qwen2-7b (reduced, fp32, 2 blocks)
    from the same state on both packages, with PIECE cut so the stacked
    leaves split: loss, grad norm, new params and factored moments."""
    monkeypatch.setattr(topt, "PIECE", 2048)
    jcfg = dataclasses.replace(jax_reduced("qwen2-7b"), n_layers=2)
    cfg = dataclasses.replace(reduced_config("qwen2-7b"), n_layers=2)
    okw = dict(name="adafactor", lr=1e-2, warmup_steps=2, decay_steps=50,
               clip_norm=1.0)
    jstate = jax_init_train_state(jax.random.key(3), jcfg, JOptConfig(**okw))
    jstate["step"] = jnp.asarray(2, jnp.int32)
    state = train_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                                   device="cpu")
    batch = JDataset(jcfg, JDataConfig(batch=2, seq_len=32)).batch_at(0)
    jnew, jmet = jax.jit(lambda s, b: jax_train_step(
        s, b, cfg=jcfg, opt_cfg=JOptConfig(**okw), journal=True))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    new, met = train_step(state, {k: torch.from_numpy(v).long()
                                  for k, v in batch.items()}, cfg,
                          OptConfig(**okw), journal=True)
    assert float(met["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-5)
    assert float(met["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]),
                                                    rel=1e-5)
    assert int(new["step"]) == 3
    assert met["integrity"].shape == np.asarray(jmet["integrity"]).shape
    assert any(len(p.shape) == 4 for p in
               jax.tree_util.tree_leaves(jstate["params"]))
    want = jax_leaves({"params": jnew["params"], "opt": jnew["opt"]})
    got = dict(leaf_paths({"params": new["params"], "opt": new["opt"]}))
    assert got.keys() == want.keys()
    # Each side's step differentiates on its own, so a param element whose
    # grad is below 1e-3 of its leaf's largest (and not zero) is not
    # compared here: Adafactor divides a row by its own RMS, so a row of
    # round-off grads (the key bias along rope's slowest pairs, which
    # barely turn over 32 positions) moves by round-off's sign.  The
    # update from the same grads is held below on every element.
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jg = jax.jit(jax.grad(lambda p: JM.forward_train(p, jcfg, jbatch)[0]))(
        jstate["params"])
    jgrads = jax_leaves(jg)
    skipped = 0
    for n, w in want.items():
        err = np.abs(got[n].numpy() - w)
        if n.startswith("['params']"):
            g = np.abs(jgrads[n[len("['params']"):]])
            keep = (g >= 1e-3 * g.max()) | (g == 0)
            skipped += int((~keep).sum())
            err = err * keep
        err = float(err.max()) / max(float(np.abs(w).max()), 1e-30)
        assert err <= 5e-5, (n, err)
    assert skipped < 0.05 * sum(w.size for n, w in want.items()
                                if n.startswith("['params']"))
    # the update alone from JAX's grads on both sides, every element: a
    # param within 5e-5 of its leaf's largest update plus two fp32 spacings
    # of its largest value (p - lr·u rounds to p's spacing), a moment
    # within 5e-5 of its leaf's largest magnitude
    jp, js, _ = jax.jit(lambda p, g, s, k: jopt.apply_updates(
        p, g, s, k, JOptConfig(**okw)))(jstate["params"], jg, jstate["opt"],
                                        jstate["step"])
    same, _ = apply_step(state, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jg), device="cpu"), met,
        OptConfig(**okw))
    old = jax_leaves(jstate["params"])
    got = dict(leaf_paths({"params": same["params"], "opt": same["opt"]}))
    for n, w in jax_leaves({"params": jp, "opt": js}).items():
        err = float(np.abs(got[n].numpy() - w).max())
        if n.startswith("['params']"):
            o = old[n[len("['params']"):]]
            top = np.float32(np.abs(w).max())
            assert err <= 5e-5 * float(np.abs(w - o).max()) + \
                2 * float(np.spacing(top)), (n, err)
        else:
            assert err <= 5e-5 * max(float(np.abs(w).max()), 1e-30), (n, err)
    # the factored second moment of the stacked MLP leaf is in the state
    assert any("vc" in n and got[n].dim() == 3 for n in got)


def test_zero_state_has_the_jax_shapes():
    params = port(inputs()[0])
    zeros = init_opt_state(params, OptConfig(**OPT))
    jz = jax_leaves(jopt.init_opt_state(inputs()[0], JOptConfig(**OPT)))
    assert {n: tuple(t.shape) for n, t in leaf_paths(zeros)} == \
        {n: a.shape for n, a in jz.items()}
