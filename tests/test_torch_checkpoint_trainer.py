"""The checkpointing trainer on the CPU, as ``chip_smoke.py`` runs it whole
on the card: a reduced qwen2-7b in fp32 with Adafactor, the trainer's
default asynchronous checkpoint every 3 steps to two ``FileStore``
replicas at W = 2, the manifests and the journal in a replicated log
(local + 1 backup, W = 2, force frequency 4).  A first life runs steps
0-3 and crashes: every object of it is dropped, and what survives is the
log's devices as their media holds them and the stores' directories.  One
byte in the payload of the largest shard on replica 0 is flipped.  A
second life, on the log rebuilt from both images by quorum recovery and
on new stores over the same directories, restores step 3 (replica 0
fails its CRC, replica 1 serves, read-repair rewrites replica 0),
re-seats the data from the journal and runs steps 3 and 4.

Held against: the state as the first life saved it (bitwise); the
uninterrupted port run (rtol 1e-5: a CPU step is not bitwise
repeatable, the embedding's grad sums duplicate tokens with atomic adds);
the JAX package's ``CheckpointManager`` restoring the port's checkpoint
(bitwise); and the JAX ``Trainer``'s uninterrupted run from the same
state, at ``test_torch_train.py``'s tolerances (1e-4 of the loss and of
each param leaf's largest magnitude).  As in ``test_torch_optimizer.py``,
a param element whose first grad is below 1e-3 of its leaf's largest (and
not zero) is not compared with the JAX run: Adafactor divides a row by
its own RMS, so a row of round-off grads (the key bias, which the softmax
ignores) moves by round-off's sign in each framework.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import repro.checkpoint as jckpt
import repro.core as jcore
from repro.configs import reduced_config as jax_reduced
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticDataset as JDataset
from repro.models import model as JM
from repro.optim import OptConfig as JOptConfig
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.checkpoint import (CheckpointConfig, CheckpointManager,
                                    FileStore, ReplicatedStore)
from repro_torch.configs import reduced_config
from repro_torch.core import (CopyAccessor, Log, ReplicaServer,
                              ReplicationGroup, Transport, quorum_recover)
from repro_torch.core.replication import build_replica_set
from repro_torch.data import DataConfig, SyntheticDataset
from repro_torch.models.convert import (train_state_from_numpy,
                                        train_state_to_numpy)
from repro_torch.optim import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaf_paths

from torch_parity import to_jax

ARCH = "qwen2-7b"
STEPS, CKPT_EVERY, FIRST_LIFE, F = 5, 3, 4, 4
OKW = dict(name="adafactor", lr=3e-3, warmup_steps=2, decay_steps=100)
DKW = dict(batch=2, seq_len=32)
REPLICAS = 2
CAP = 1 << 20


def fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def leaves(state):
    """{leaf path: numpy array} of a port train state."""
    return dict(leaf_paths(train_state_to_numpy(state)))


def max_rel_err(got, want):
    """The largest leaf-wise |got - want| over the leaf's largest |want|."""
    return max(float(np.abs(got[p].astype(np.float64) - want[p]).max())
               / max(float(np.abs(want[p]).max()), 1e-30) for p in want)


class Recording(Trainer):
    """The port's trainer, keeping a numpy copy of each state it saves."""

    def _checkpoint(self, step):
        self.saved = (step, leaves(self.state))
        super()._checkpoint(step)


def port_trainer(log, root, start=None, cls=Trainer):
    cfg = fp32(reduced_config(ARCH))
    stores = [FileStore(str(root / f"replica{i}"), f"fs{i}")
              for i in range(REPLICAS)]
    mgr = CheckpointManager(ReplicatedStore(stores, write_quorum=2), log,
                            CheckpointConfig(force_freq=F))
    tr = cls(cfg, OptConfig(**OKW), SyntheticDataset(cfg, DataConfig(**DKW)),
             mgr, TrainerConfig(total_steps=STEPS, ckpt_every=CKPT_EVERY,
                                journal_freq=F), device="cpu")
    if start is not None:
        tr.state = train_state_from_numpy(start, "cpu")
    return tr


def replicated_log():
    return build_replica_set(mode="local+remote", capacity=CAP, n_backups=1,
                             write_quorum=2, device="cpu")


def flip_middle_byte(path):
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    path.write_bytes(bytes(raw))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX trainer's run, the port's uninterrupted run from the same
    state, and the port's crash and restart, once for the module."""
    tmp = tmp_path_factory.mktemp("ckpt_trainer")
    out = {}

    # the JAX package's trainer: its start state is everyone's
    jcfg = fp32(jax_reduced(ARCH))
    jlog = jcore.Log.create(jcore.PMEMDevice(CAP + 4096),
                            jcore.LogConfig(capacity=CAP))
    jmgr = jckpt.CheckpointManager(
        jckpt.ReplicatedStore([jckpt.ObjectStore("s0")], 1), jlog,
        jckpt.CheckpointConfig(force_freq=F))
    jtr = JTrainer(jcfg, JOptConfig(**OKW), JDataset(jcfg, JDataConfig(**DKW)),
                   jmgr, JTrainerConfig(total_steps=STEPS,
                                        ckpt_every=CKPT_EVERY, journal_freq=F))
    jtr.init_or_restore()
    start = jax.tree_util.tree_map(np.asarray, jtr.state)
    out["jax_losses"] = jtr.run().losses
    out["jax_params"] = dict(leaf_paths(jax.tree_util.tree_map(
        np.asarray, jtr.state["params"])))
    jmgr.close()
    batch = {k: jnp.asarray(v) for k, v in jtr.data.batch_at(0).items()}
    out["jax_grads"] = dict(leaf_paths(jax.tree_util.tree_map(
        np.asarray, jax.grad(lambda p: JM.forward_train(p, jcfg, batch)[0])(
            jax.tree_util.tree_map(jnp.asarray, start["params"])))))

    # the port, straight through
    rs = replicated_log()
    try:
        ref = port_trainer(rs.log, tmp / "ref", start)
        out["ref_losses"] = ref.run().losses
        out["ref_state"] = leaves(ref.state)
        ref.mgr.close()
    finally:
        rs.shutdown()

    # the first life, then the crash
    root = tmp / "stores"
    rs = replicated_log()
    try:
        first = port_trainer(rs.log, root, start, cls=Recording)
        rep1 = first.run(n_steps=FIRST_LIFE)
        out["first"] = dict(losses=rep1.losses, saved=first.saved,
                            ckpts=(rep1.ckpts_saved, rep1.ckpts_skipped),
                            last_lsn=rs.log.next_lsn - 1)
        images = [d.crash(np.random.default_rng(i), keep_probability=0.0)
                  for i, d in enumerate((rs.primary_dev,
                                         rs.servers[0].device))]
        first.mgr.close()
        lcfg = rs.cfg
    finally:
        rs.shutdown()
    del first
    out["jax_image"] = to_jax(images[0])
    big = max((root / "replica0").iterdir(), key=lambda p: p.stat().st_size)
    flip_middle_byte(big)
    out["corrupted"] = big.read_bytes() != (root / "replica1" /
                                            big.name).read_bytes()

    # the second life
    accs = [CopyAccessor.for_device("node0", images[0]),
            CopyAccessor.for_device("node1", images[1])]
    img, _ = quorum_recover(accs, lcfg, lcfg.write_quorum, local_name="node0",
                            device="cpu")
    group = ReplicationGroup(
        [Transport(ReplicaServer(images[1], server_id="node1"),
                   primary_id="node0")], lcfg.write_quorum,
        local_is_durable=True)
    try:
        second = port_trainer(Log.open(img, lcfg, repl=group, device="cpu"),
                              root)
        out["restored_step"] = second.init_or_restore()
        out["seated"] = second.data.step
        out["restored"] = leaves(second.state)
        out["repaired"] = big.read_bytes() == (root / "replica1" /
                                               big.name).read_bytes()
        rep2 = second.run()
        out["resumed_losses"] = rep2.losses
        out["resumed_state"] = leaves(second.state)
        out["journal"] = second.mgr.journal_records()
        out["manifests"] = [m["step"] for _, m in second.mgr.manifests()]
        out["durable"] = second.mgr.log.durable_lsn
        second.mgr.close()
    finally:
        group.shutdown()
    out["root"] = root
    out["start"] = start
    return out


def test_restart_restores_step_3_byte_exact_and_read_repairs(runs):
    step, saved = runs["first"]["saved"]
    assert step == runs["restored_step"] == CKPT_EVERY
    assert runs["seated"] == FIRST_LIFE        # the journal re-seated it
    assert runs["restored"].keys() == saved.keys()
    for p, want in saved.items():
        got = runs["restored"][p]
        assert got.dtype == want.dtype and np.array_equal(got, want), p
    assert runs["corrupted"] and runs["repaired"]


def test_resumed_run_repeats_the_uninterrupted_one(runs):
    np.testing.assert_allclose(runs["resumed_losses"],
                               runs["ref_losses"][CKPT_EVERY:], rtol=1e-5)
    np.testing.assert_allclose(runs["first"]["losses"],
                               runs["ref_losses"][:FIRST_LIFE], rtol=1e-5)
    assert max_rel_err(runs["resumed_state"], runs["ref_state"]) <= 1e-5


def test_each_life_journals_its_steps_and_the_manifest_commits(runs):
    first_last = runs["first"]["last_lsn"]
    lives = ([r for lsn, r in runs["journal"] if lsn <= first_last],
             [r for lsn, r in runs["journal"] if lsn > first_last])
    assert lives[0] == [{"step": s, "loss": loss} for s, loss in
                        enumerate(runs["first"]["losses"])]
    assert lives[1] == [{"step": s, "loss": loss} for s, loss in
                        zip(range(CKPT_EVERY, STEPS), runs["resumed_losses"])]
    assert runs["durable"] >= max(lsn for lsn, _ in runs["journal"])
    assert runs["manifests"] == [CKPT_EVERY]
    assert sum(runs["first"]["ckpts"]) == 1


def test_jax_manager_restores_the_port_trainers_checkpoint(runs):
    jlog = jcore.Log.open(runs["jax_image"], jcore.LogConfig(capacity=CAP))
    stores = [jckpt.FileStore(str(runs["root"] / f"replica{i}"), f"fs{i}")
              for i in range(REPLICAS)]
    jmgr = jckpt.CheckpointManager(jckpt.ReplicatedStore(stores, 2), jlog)
    step, got, extra = jmgr.restore(runs["start"])
    assert step == CKPT_EVERY
    assert extra["data_state"]["step"] == CKPT_EVERY
    got = dict(leaf_paths(jax.tree_util.tree_map(np.asarray, got)))
    _, saved = runs["first"]["saved"]
    assert got.keys() == saved.keys()
    for p, want in saved.items():
        assert np.array_equal(got[p], want), p
    jmgr.close()


def test_uninterrupted_run_matches_the_jax_trainer(runs):
    np.testing.assert_allclose(runs["ref_losses"], runs["jax_losses"],
                               rtol=1e-4)
    params = {p[len("['params']"):]: x for p, x in runs["ref_state"].items()
              if p.startswith("['params']")}
    assert params.keys() == runs["jax_params"].keys()
    skipped = 0
    for p, want in runs["jax_params"].items():
        g = np.abs(runs["jax_grads"][p])
        keep = (g >= 1e-3 * g.max()) | (g == 0)
        skipped += int((~keep).sum())
        err = float((np.abs(params[p] - want) * keep).max())
        assert err <= 1e-4 * max(float(np.abs(want).max()), 1e-30), (p, err)
    assert skipped < 0.05 * sum(w.size for w in runs["jax_params"].values())
