"""The port's training slice against the JAX package's on the CPU: the data
pipeline, the optimizers, the grads' integrity hashes, ``forward_train``'s
loss and grads for every family, one trainer run from the same state, and
the port's counterparts of tests/test_trainer.py's scenarios.

Inputs and initial states come from the JAX package (numpy-seeded
batches, ``jax.random`` params) and are carried across through numpy
(``train_state_from_numpy``).  Tolerances: batches and hashes exactly;
the optimizers' updates within 1e-6 (fp32, the same operations in the
same order); ``forward_train`` in fp32 within 1e-5 of the loss and 5e-5
of each grad leaf's largest magnitude (the largest gap seen is 8.2e-6, on
jamba's dt_bias; the two frameworks sum in other orders); a 4-step
trainer run within 1e-4 of the loss and of each param leaf's largest
magnitude.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.checkpoint as jckpt
import repro.core as jcore
from repro.configs import reduced_config as jax_reduced
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticDataset as JDataset
from repro.kernels.checksum import ops as jcksum
from repro.models import model as JM
from repro.optim import OptConfig as JOptConfig
from repro.optim import optimizer as jopt
from repro.train.step import init_train_state as jax_init_train_state
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.checkpoint import (CheckpointConfig, CheckpointManager,
                                    ObjectStore, ReplicatedStore)
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import Log, LogConfig, PMEMDevice
from repro_torch.data import DataConfig, SyntheticDataset
from repro_torch.kernels.checksum import ops as cksum
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import (params_from_numpy,
                                        train_state_from_numpy,
                                        train_state_to_numpy)
from repro_torch.optim import (OptConfig, apply_updates, init_opt_state,
                               schedule)
from repro_torch.train.step import apply_step, grads_and_metrics
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaf_paths

CAP = 1 << 18
TRAIN_ARCHS = ["mamba2-130m", "qwen2-7b", "gemma2-9b", "deepseek-v3-671b",
               "jamba-1.5-large-398b", "hubert-xlarge"]


def fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def init_params_cpu(cfg):
    from repro_torch.models.model import init_params
    return init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


def jax_leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def leaf_rel_errs(port_tree, jax_tree):
    want = jax_leaves(jax_tree)
    got = dict(leaf_paths(port_tree))
    assert set(got) == set(want)
    return {n: float(np.abs(got[n].detach().float().numpy() - want[n]).max()
                     / max(float(np.abs(want[n]).max()), 1e-30))
            for n in want}


# ------------------------------- data ----------------------------------- #

@pytest.mark.parametrize("arch", ["mamba2-130m", "llava-next-34b",
                                  "hubert-xlarge"])
def test_synthetic_batches_equal_jax(arch):
    cfg = reduced_config(arch)
    dcfg = dict(seed=3, batch=3, seq_len=48)
    port = SyntheticDataset(cfg, DataConfig(**dcfg))
    ref = JDataset(jax_reduced(arch), JDataConfig(**dcfg))
    for step in (0, 1, 17):
        a, b = port.batch_at(step), ref.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    t = port.tensors_at(1, "cpu")
    assert all(v.dtype == (torch.float32 if k in ("frames", "patches")
                           else torch.int64) for k, v in t.items())
    port.next_batch()
    assert port.state() == {"seed": 3, "step": 1}
    with pytest.raises(ValueError):
        port.restore({"seed": 4, "step": 0})


# ----------------------------- optimizers ------------------------------- #

def test_schedule_matches_jax():
    cfg = OptConfig(lr=3e-3, warmup_steps=5, decay_steps=40)
    jcfg = JOptConfig(lr=3e-3, warmup_steps=5, decay_steps=40)
    for step in (0, 1, 4, 5, 6, 20, 39, 40, 100):
        got = float(schedule(torch.tensor(step, dtype=torch.int32), cfg))
        want = float(jopt.schedule(jnp.asarray(step, jnp.int32), jcfg))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["mamba2-130m", "qwen2-7b"])
def test_optimizer_update_matches_jax(name, arch):
    """One update from the same params, grads and (non-zero) state, with
    the clip active: new params and moments leaf by leaf within 1e-6."""
    jcfg = fp32(jax_reduced(arch))
    ocfg = dict(name=name, lr=1e-2, warmup_steps=2, decay_steps=50,
                clip_norm=0.5)
    params = jax.tree_util.tree_map(
        np.asarray, JM.init_params(jax.random.key(1), jcfg))
    rng = np.random.default_rng(2)
    grads = jax.tree_util.tree_map(
        lambda p: rng.normal(size=p.shape).astype(np.float32), params)
    state = jax.tree_util.tree_map(
        lambda s: np.abs(rng.normal(size=s.shape)).astype(np.float32) * 1e-3,
        jax.tree_util.tree_map(np.asarray, jopt.init_opt_state(
            params, JOptConfig(**ocfg))))
    step = 7
    jp, js, jm = jax.jit(jopt.apply_updates, static_argnums=4)(
        *(jax.tree_util.tree_map(jnp.asarray, t)
          for t in (params, grads, state)),
        jnp.asarray(step, jnp.int32), JOptConfig(**ocfg))
    tp, ts, tm = apply_updates(
        params_from_numpy(params, "cpu"), params_from_numpy(grads, "cpu"),
        params_from_numpy(state, "cpu"), torch.tensor(step, dtype=torch.int32),
        OptConfig(**ocfg))
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-6)
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    for got, want in ((tp, jp), (ts, js)):
        g, w = dict(leaf_paths(got)), jax_leaves(want)
        assert g.keys() == w.keys()
        for n in w:
            np.testing.assert_allclose(g[n].numpy(), w[n], rtol=1e-6,
                                       atol=1e-6, err_msg=n)
    # the zero state the trainer starts from has the JAX package's shapes
    zeros = init_opt_state(params_from_numpy(params, "cpu"), OptConfig(**ocfg))
    jz = jax_leaves(jopt.init_opt_state(params, JOptConfig(**ocfg)))
    assert {n: tuple(t.shape) for n, t in leaf_paths(zeros)} == \
        {n: a.shape for n, a in jz.items()}


# ------------------------------ integrity -------------------------------- #

def test_tree_checksums_equal_jax():
    """The same grads -> the same per-leaf hashes, exactly, in the JAX
    package's leaf order (fp32 leaves and a bf16 one)."""
    import ml_dtypes
    cfg = fp32(jax_reduced("mamba2-130m"))
    rng = np.random.default_rng(4)
    tree = jax.tree_util.tree_map(
        lambda p: rng.normal(size=p.shape).astype(np.float32),
        jax.tree_util.tree_map(np.asarray,
                               JM.init_params(jax.random.key(0), cfg)))
    tree["extra"] = {"b": rng.normal(size=(7, 3)).astype(ml_dtypes.bfloat16)}
    want = np.asarray(jcksum.tree_checksums(
        jax.tree_util.tree_map(jnp.asarray, tree), use_pallas=False))
    got = cksum.tree_checksums(params_from_numpy(tree, "cpu"))
    assert got.dtype == torch.int64
    assert got.tolist() == [int(x) for x in want]


# ---------------------------- forward_train ------------------------------ #

@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_forward_train_loss_and_grads_match_jax(arch):
    jcfg, cfg = fp32(jax_reduced(arch)), fp32(reduced_config(arch))
    jstate = jax_init_train_state(jax.random.key(0), jcfg, JOptConfig())
    state = train_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                                   device="cpu")
    batch = JDataset(jcfg, JDataConfig(batch=2, seq_len=32)).batch_at(0)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JM.forward_train(p, jcfg, b), has_aux=True))(
        jstate["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    grads, met = grads_and_metrics(state["params"], port_batch(batch), cfg)
    assert set(met) == set(jmet)
    for k in jmet:
        assert float(met[k]) == pytest.approx(float(jmet[k]), rel=1e-5,
                                              abs=1e-7), k
    errs = leaf_rel_errs(grads, jgrads)
    assert max(errs.values()) <= 5e-5, sorted(errs.items(),
                                              key=lambda kv: -kv[1])[:3]
    for n, g in leaf_paths(grads):
        assert g.dtype == torch.float32 and not g.requires_grad, n


def test_train_state_round_trip():
    cfg = fp32(jax_reduced("jamba-1.5-large-398b"))
    jstate = jax.tree_util.tree_map(
        np.asarray, jax_init_train_state(jax.random.key(2), cfg, JOptConfig()))
    back = train_state_to_numpy(train_state_from_numpy(jstate, "cpu"))
    assert jax_leaves(back).keys() == jax_leaves(jstate).keys()
    for n, a in jax_leaves(jstate).items():
        b = jax_leaves(back)[n]
        assert a.dtype == b.dtype and np.array_equal(a, b), n


def test_trainer_run_matches_jax_trainer():
    """Four journaled steps of mamba2-130m (reduced) from the same state,
    checkpointed at step 2, on both packages' trainers: the losses and the
    final params agree, and the port's journal holds the same records."""
    arch = "mamba2-130m"
    jcfg, cfg = fp32(jax_reduced(arch)), fp32(reduced_config(arch))
    okw = dict(name="adamw", lr=3e-3, warmup_steps=2, decay_steps=1000,
               clip_norm=1.0)
    tkw = dict(total_steps=4, ckpt_every=2, async_ckpt=False)
    dkw = dict(batch=2, seq_len=64)

    jlog = jcore.Log.create(jcore.PMEMDevice(CAP + 4096),
                            jcore.LogConfig(capacity=CAP))
    jmgr = jckpt.CheckpointManager(
        jckpt.ReplicatedStore([jckpt.ObjectStore("s0")], 1), jlog,
        jckpt.CheckpointConfig())
    jtr = JTrainer(jcfg, JOptConfig(**okw), JDataset(jcfg, JDataConfig(**dkw)),
                   jmgr, JTrainerConfig(**tkw))
    jtr.init_or_restore()
    start = jax.tree_util.tree_map(np.asarray, jtr.state)
    jrep = jtr.run()

    tr, _, log = build_trainer(arch, total=4, ckpt_every=2, batch=2, seq=64)
    assert tr.cfg == cfg
    tr.state = train_state_from_numpy(start, "cpu")
    rep = tr.run()
    np.testing.assert_allclose(rep.losses, jrep.losses, rtol=1e-4)
    errs = leaf_rel_errs(tr.state["params"], jtr.state["params"])
    assert max(errs.values()) <= 1e-4, errs
    assert int(tr.state["step"]) == 4
    assert [r for _, r in tr.mgr.journal_records()] == \
        [{"step": s, "loss": loss} for s, loss in enumerate(rep.losses)]
    assert [m["step"] for _, m in tr.mgr.manifests()] == \
        [m["step"] for _, m in jmgr.manifests()] == [2, 4]


# --------------------- tests/test_trainer.py's scenarios ----------------- #

def build_trainer(arch="qwen2-7b", force_freq=1, total=12, ckpt_every=4,
                  stores=None, log=None, device_mode="fast", batch=4, seq=64):
    """tests/test_trainer.py's ``build`` on the port, on the CPU."""
    cfg = reduced_config(arch)
    data = SyntheticDataset(cfg, DataConfig(batch=batch, seq_len=seq))
    stores = stores or [ObjectStore(f"s{i}") for i in range(2)]
    rstore = ReplicatedStore(stores, write_quorum=1)
    if log is None:
        dev = PMEMDevice(CAP + 4096, mode=device_mode)
        log = Log.create(dev, LogConfig(capacity=CAP), device="cpu")
    mgr = CheckpointManager(rstore, log,
                            CheckpointConfig(force_freq=force_freq))
    opt = OptConfig(name="adamw", lr=3e-3, warmup_steps=2,
                    decay_steps=1000, clip_norm=1.0)
    tr = Trainer(cfg, opt, data, mgr,
                 TrainerConfig(total_steps=total, ckpt_every=ckpt_every,
                               async_ckpt=False),
                 device="cpu")
    return tr, stores, log


def loss_decreases():
    tr, *_ = build_trainer(total=30, ckpt_every=100, batch=8)
    tr.init_or_restore()
    rep = tr.run()
    first, last = np.mean(rep.losses[:4]), np.mean(rep.losses[-4:])
    assert last < first - 1.0, (first, last)


def crash_restart_resumes_exactly():
    """Uninterrupted run == run that crashes at step 8 and restarts; every
    step journaled with its grads' hashes."""
    tr_ref, *_ = build_trainer(total=12, ckpt_every=4)
    tr_ref.init_or_restore()
    rep_ref = tr_ref.run()
    tr1, stores, log = build_trainer(total=12, ckpt_every=4)
    tr1.init_or_restore()
    tr1.run(n_steps=8)                      # "crash" here (state discarded)
    tr2, _, _ = build_trainer(total=12, ckpt_every=4, stores=stores, log=log)
    assert tr2.init_or_restore() == 8       # newest committed checkpoint
    assert tr2.data.step >= 8               # journal re-seated the data
    rep2 = tr2.run()
    np.testing.assert_allclose(rep2.losses, rep_ref.losses[8:], rtol=1e-5)


def frequency_policy_bounds_journal_loss():
    """With force frequency F and a crash, at most F×T journal records of
    progress are lost."""
    F = 4
    dev = PMEMDevice(CAP + 4096, mode="strict")
    log = Log.create(dev, LogConfig(capacity=CAP, max_threads=1),
                     device="cpu")
    tr, stores, _ = build_trainer(total=10, ckpt_every=100, force_freq=F,
                                  log=log)
    tr.init_or_restore()
    tr.run(n_steps=10)
    # crash WITHOUT drain: reopen from the durable image only
    survivor = dev.crash(np.random.default_rng(0), keep_probability=0.0)
    relog = Log.open(survivor, LogConfig(capacity=CAP), device="cpu")
    mgr2 = CheckpointManager(ReplicatedStore(stores, 1), relog,
                             CheckpointConfig(force_freq=F))
    recs = [r["step"] for _, r in mgr2.journal_records()]
    durable = max(recs) + 1 if recs else 0
    assert 10 - durable <= F * log.cfg.max_threads


def straggler_skip_counted():
    tr, *_ = build_trainer(total=12, ckpt_every=2)
    tr.tcfg.async_ckpt = True
    tr.init_or_restore()

    class SlowFut:
        def done(self):
            return False
    tr._pending_save = SlowFut()           # an in-flight save that never ends
    tr.run(n_steps=6)
    assert tr.report.ckpts_skipped >= 1


def elastic_restore_across_chunk_counts():
    """A checkpoint written with 1 chunk restores into a 4-chunk manager and
    training continues."""
    tr, stores, log = build_trainer(total=8, ckpt_every=4)
    tr.init_or_restore()
    tr.run()
    cfg = reduced_config("qwen2-7b")
    mgr4 = CheckpointManager(ReplicatedStore(stores, write_quorum=1), log,
                             CheckpointConfig(chunks_per_leaf=4))
    data = SyntheticDataset(cfg, DataConfig(batch=2, seq_len=32))
    opt = OptConfig(name="adamw", lr=1e-2, warmup_steps=2, decay_steps=100)
    tr2 = Trainer(cfg, opt, data, mgr4,
                  TrainerConfig(total_steps=10, ckpt_every=4,
                                async_ckpt=False), device="cpu")
    assert tr2.init_or_restore() == 8
    assert tr2.run().steps_run == 2


def adafactor_variant_trains():
    cfg = reduced_config("mamba2-130m")
    data = SyntheticDataset(cfg, DataConfig(batch=2, seq_len=32))
    log = Log.create(PMEMDevice(CAP + 4096), LogConfig(capacity=CAP),
                     device="cpu")
    mgr = CheckpointManager(ReplicatedStore([ObjectStore("s0")], 1), log,
                            CheckpointConfig())
    opt = OptConfig(name="adafactor", lr=1e-2, warmup_steps=2,
                    decay_steps=100)
    tr = Trainer(cfg, opt, data, mgr,
                 TrainerConfig(total_steps=10, ckpt_every=5,
                               async_ckpt=False), device="cpu")
    tr.init_or_restore()
    rep = tr.run()
    assert np.isfinite(rep.losses).all()
    assert np.mean(rep.losses[-3:]) < np.mean(rep.losses[:3])


SCENARIOS = {f.__name__: f for f in (
    loss_decreases, crash_restart_resumes_exactly,
    frequency_policy_bounds_journal_loss, straggler_skip_counted,
    elastic_restore_across_chunk_counts, adafactor_variant_trains)}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_trainer_scenario(scenario):
    SCENARIOS[scenario]()


def test_journaled_step_records_the_grads_hashes():
    """``journal=True`` adds one hash per grad leaf: the plain hash of the
    grads the step applied (hashed from the same tensors: on the CPU the
    embedding's grad sums duplicate tokens with atomic adds, so a second
    backward need not repeat it bitwise)."""
    cfg = reduced_config("mamba2-130m")
    tr, *_ = build_trainer("mamba2-130m", total=1)
    tr.init_or_restore()
    batch = tr.data.tensors_at(0, "cpu")
    grads, met = grads_and_metrics(tr.state["params"], batch, cfg)
    new, met = apply_step(tr.state, grads, met, tr.opt_cfg, journal=True)
    want = [int(cksum.ref.tensor_checksum(g)) for _, g in leaf_paths(grads)]
    assert met["integrity"].tolist() == want
    assert len(want) == len(list(leaf_paths(tr.state["params"])))
    assert int(new["step"]) == 1


def test_check_trainable_refuses_attention_on_the_card():
    """Decided from the config alone, before anything is allocated: the
    attention configs train on the card now that flash attention has a
    backward kernel, unless their head dims are ones the flash kernels do
    not take; the ``ssm_chunk`` rule still refuses on either device."""
    for arch in ("qwen2-7b", "gemma2-9b", "deepseek-v3-671b",
                 "jamba-1.5-large-398b", "hubert-xlarge", "starcoder2-3b"):
        for device in ("cuda", "cpu"):
            launch_train.check_trainable(reduced_config(arch), device)
            launch_train.check_trainable(get_config(arch), device)
    wide = dataclasses.replace(reduced_config("qwen2-7b"), head_dim=288)
    with pytest.raises(ValueError, match="not taken by the flash kernels"):
        launch_train.check_trainable(wide, "cuda")
    launch_train.check_trainable(wide, "cpu")
    launch_train.check_trainable(reduced_config("mamba2-130m"), "cuda", 4096)
    for device in ("cuda", "cpu"):
        with pytest.raises(ValueError, match="ssm_chunk"):
            launch_train.check_trainable(reduced_config("mamba2-130m"),
                                         device, 300)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_donated_update_is_bitwise_the_functional_one(monkeypatch, name):
    """``apply_updates(..., donate=True)`` writes each leaf's new values
    into its old tensors (in pieces, here of 1000 elements, so that
    leaves straddle pieces) and gives the functional update's bits."""
    from repro_torch.optim import optimizer as topt

    monkeypatch.setattr(topt, "PIECE", 1000)
    cfg = fp32(reduced_config("qwen2-7b"))
    ocfg = OptConfig(name=name, lr=1e-2, warmup_steps=2, decay_steps=50,
                     clip_norm=0.5)
    gen = torch.Generator().manual_seed(3)
    params = {n: torch.randn(t.shape, generator=gen)
              for n, t in leaf_paths(init_params_cpu(cfg))}
    grads = {n: torch.randn(t.shape, generator=gen) for n, t in params.items()}
    state = init_opt_state(params, ocfg)
    state = {n: {k: v.abs() * 1e-3 + torch.rand(v.shape, generator=gen) * 1e-4
                 for k, v in s.items()} for n, s in state.items()}
    step = torch.tensor(7, dtype=torch.int32)
    want_p, want_s, want_m = apply_updates(params, grads, state, step, ocfg)
    ptrs = {n: t.data_ptr() for n, t in params.items()}
    got_p, got_s, got_m = apply_updates(params, grads, state, step, ocfg,
                                        donate=True)
    assert all(got_p[n] is params[n] for n in params)
    assert all(got_s[n][k] is state[n][k] for n in state for k in state[n])
    assert {n: t.data_ptr() for n, t in got_p.items()} == ptrs
    for n in want_p:
        assert torch.equal(got_p[n], want_p[n]), n
        for k in want_s[n]:
            assert torch.equal(got_s[n][k], want_s[n][k]), (n, k)
    assert torch.equal(got_m["grad_norm"], want_m["grad_norm"])


def test_launcher_trains_on_the_cpu(capsys):
    launch_train.main(["--arch", "mamba2-130m", "--reduced", "--device",
                       "cpu", "--steps", "4", "--batch", "2", "--seq", "32",
                       "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "[train] 4 steps" in out
    saved, skipped = map(int, re.search(r"ckpts saved=(\d+) skipped=(\d+)",
                                        out).groups())
    assert saved + skipped == 2 and saved >= 1
