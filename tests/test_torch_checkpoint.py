"""The port's checkpoint manager (over the port's log, on the CPU): the
scenarios of tests/test_checkpoint.py, and byte-level agreement with the
JAX package — the same shards and manifests for the same state, and a
checkpoint written by one package restored by the other from its log
image."""

import numpy as np
import pytest
import torch

import jax

import repro.checkpoint as jckpt
import repro.core as jcore
from repro_torch.checkpoint import (CheckpointConfig, CheckpointManager,
                                    ObjectStore, ReplicatedStore,
                                    ShardCorruptError, ShardMeta,
                                    decode_shard, encode_shard)
from repro_torch.core import Log, LogConfig, PMEMDevice, QuorumError
from repro_torch.core.replication import build_replica_set
from repro_torch.tree import leaf_paths

from torch_parity import to_jax, to_port

CAP = 1 << 18


def make_mgr(n_stores=3, store_quorum=2, **cfg):
    stores = [ObjectStore(f"store{i}") for i in range(n_stores)]
    rstore = ReplicatedStore(stores, write_quorum=store_quorum)
    dev = PMEMDevice(CAP + 4096)
    log = Log.create(dev, LogConfig(capacity=CAP), device="cpu")
    mgr = CheckpointManager(rstore, log, CheckpointConfig(**cfg))
    return mgr, stores, log


def make_state(seed=0, dim=32):
    """tests/test_checkpoint.py's state, with the parameters as tensors."""
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "embed": torch.from_numpy(
                rng.normal(size=(dim, 8)).astype(np.float32)),
            "layer": {"w": torch.from_numpy(
                rng.normal(size=(8, 8)).astype(np.float32)),
                "b": torch.zeros(8, dtype=torch.float32)},
        },
        "opt": {"mu": rng.normal(size=(dim, 8)).astype(np.float32)},
        "step": np.int64(0),
    }


def numpy_state(state):
    """The same state with numpy leaves only (what the JAX package saves)."""
    return {"params": {"embed": state["params"]["embed"].numpy(),
                       "layer": {k: v.numpy() for k, v in
                                 state["params"]["layer"].items()}},
            "opt": state["opt"], "step": state["step"]}


def assert_tree_equal(a, b):
    la = [x for _, x in leaf_paths(a)]
    lb = [y for _, y in leaf_paths(b)]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert type(x) is type(y) or isinstance(y, np.generic)
        xa = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        ya = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert xa.dtype == ya.dtype
        np.testing.assert_array_equal(xa, ya)


def test_save_restore_roundtrip():
    mgr, stores, log = make_mgr()
    state = make_state()
    mgr.save(10, state, extra={"data_pos": 1234}, sync=True)
    step, got, extra = mgr.restore(state)
    assert step == 10 and extra == {"data_pos": 1234}
    assert isinstance(got["params"]["embed"], torch.Tensor)
    assert isinstance(got["opt"]["mu"], np.ndarray)
    assert_tree_equal(got, state)


def test_restore_latest_of_many():
    mgr, stores, log = make_mgr()
    states = {s: make_state(seed=s) for s in (1, 2, 3)}
    for s, st in states.items():
        mgr.save(s, st, sync=True)
    step, got, _ = mgr.restore(states[1])
    assert step == 3
    assert_tree_equal(got, states[3])
    step, got, _ = mgr.restore(states[1], step=2)   # point-in-time
    assert step == 2
    assert_tree_equal(got, states[2])


def test_corrupt_shard_falls_back_to_replica_and_repairs():
    mgr, stores, log = make_mgr()
    state = make_state()
    mgr.save(1, state, sync=True)
    key = [k for k in stores[0].keys() if "embed" in k][0]
    stores[0].corrupt(key, seed=3)
    step, got, _ = mgr.restore(state)
    assert_tree_equal(got, state)                    # replica fallback
    assert stores[0].get(key) == stores[1].get(key)  # read-repair


def test_all_replicas_corrupt_falls_back_to_older_checkpoint():
    mgr, stores, log = make_mgr()
    s1, s2 = make_state(1), make_state(2)
    mgr.save(1, s1, sync=True)
    mgr.save(2, s2, sync=True)
    key = [k for k in stores[0].keys() if "step000000000002" in k][0]
    for st in stores:
        st.corrupt(key, seed=5)
    step, got, _ = mgr.restore(s1)
    assert step == 1
    assert_tree_equal(got, s1)


def test_torn_shard_write_detected():
    mgr, stores, log = make_mgr()
    state = make_state()
    mgr.save(1, state, sync=True)
    key = stores[0].keys()[0]
    n = len(stores[0].get(key))
    for st in stores:
        st.truncate(key, keep=n // 2)
    with pytest.raises(ShardCorruptError):
        mgr.restore(state)


def test_put_quorum():
    mgr, stores, log = make_mgr(n_stores=3, store_quorum=2)
    stores[2].dead = True
    mgr.save(1, make_state(), sync=True)              # 2/3 acks: ok
    stores[1].dead = True
    with pytest.raises(QuorumError):
        mgr.save(2, make_state(), sync=True)          # 1/3 acks: fail


def test_elastic_restore_different_chunk_count():
    stores = [ObjectStore("s0")]
    rstore = ReplicatedStore(stores, write_quorum=1)
    log = Log.create(PMEMDevice(CAP + 4096), LogConfig(capacity=CAP),
                     device="cpu")
    w = CheckpointManager(rstore, log, CheckpointConfig(chunks_per_leaf=4))
    state = make_state(dim=64)
    w.save(7, state, sync=True)
    assert sum("c3of4" in k for k in stores[0].keys()) == 4   # 4 leaves
    r = CheckpointManager(rstore, log, CheckpointConfig(chunks_per_leaf=1))
    step, got, _ = r.restore(state)
    assert step == 7
    assert_tree_equal(got, state)


def test_frequency_policy_bounded_loss():
    F = 4
    stores = [ObjectStore("s0")]
    rstore = ReplicatedStore(stores, write_quorum=1)
    dev = PMEMDevice(CAP + 4096, mode="strict")
    log = Log.create(dev, LogConfig(capacity=CAP, max_threads=1),
                     device="cpu")
    mgr = CheckpointManager(rstore, log, CheckpointConfig(force_freq=F))
    state = make_state()
    last = 17
    for s in range(1, last + 1):
        mgr.save(s, state)
    survivor = dev.crash(np.random.default_rng(0), keep_probability=0.0)
    relog = Log.open(survivor, LogConfig(capacity=CAP), device="cpu")
    rmgr = CheckpointManager(rstore, relog, CheckpointConfig(force_freq=F))
    step, got, _ = rmgr.restore(state)
    assert last - step <= F * log.cfg.max_threads
    assert step == 16                      # last lsn divisible by F
    assert_tree_equal(got, state)


def test_journal_records_roundtrip():
    mgr, stores, log = make_mgr()
    mgr.save(1, make_state(), sync=True)
    for i in range(5):
        mgr.journal({"step": i, "loss": float(i) * 0.5}, sync=True)
    assert [r["step"] for _, r in mgr.journal_records()] == list(range(5))


@pytest.mark.parametrize("trim", [True, False])
def test_gc_reclaims_old_checkpoints(trim):
    mgr, stores, log = make_mgr(keep_last=2)
    state = make_state()
    for s in range(1, 6):
        mgr.save(s, state, sync=True)
    assert mgr.gc(trim=trim) == 3
    assert [m["step"] for _, m in mgr.manifests()] == [4, 5]
    assert not any("step000000000001" in k for k in stores[0].keys())
    step, got, _ = mgr.restore(state)
    assert step == 5


def test_save_async_overlaps():
    mgr, stores, log = make_mgr()
    state = make_state()
    futs = [mgr.save_async(s, state) for s in (1, 2, 3)]
    mgr.wait()
    assert [f.result() for f in futs] == sorted(f.result() for f in futs)
    assert mgr.latest_step() == 3
    mgr.close()


def test_replicated_log_backs_the_manifests():
    """The manifest commits through a replicated log (2 backups, W = 2 of
    3), and a checkpoint restores from a log rebuilt off a backup."""
    rs = build_replica_set(mode="local+remote", capacity=CAP, n_backups=2,
                           write_quorum=2, device="cpu")
    try:
        stores = [ObjectStore(f"store{i}") for i in range(3)]
        mgr = CheckpointManager(ReplicatedStore(stores, write_quorum=2),
                                rs.log)
        state = make_state()
        lsn = mgr.save(3, state, sync=True)
        assert rs.log.durable_lsn >= lsn
        rs.group.drain()
        backup = Log.open(rs.servers[0].device, LogConfig(capacity=CAP),
                          device="cpu")
        step, got, _ = CheckpointManager(mgr.store, backup).restore(state)
        assert step == 3
        assert_tree_equal(got, state)
        mgr.close()
    finally:
        rs.shutdown()


# ----------------------- agreement with the JAX package ------------------ #

@pytest.mark.parametrize("chunk", [None, (2, 3)])
def test_encoded_shards_are_byte_identical(chunk):
    rng = np.random.default_rng(9)
    arr = rng.normal(size=(6, 5)).astype(np.float32)
    meta = dict(key="step000000000004['a']/c0of1", step=4, dtype="float32",
                shape=arr.shape, chunk_index=0, n_chunks=1,
                global_shape=arr.shape)
    if chunk:
        meta.update(chunk_index=chunk[0], n_chunks=chunk[1])
    raw = encode_shard(arr, ShardMeta(**meta))
    assert raw == jckpt.encode_shard(arr, jckpt.ShardMeta(**meta))
    got, m = decode_shard(raw)
    np.testing.assert_array_equal(got, arr)
    assert m == ShardMeta(**meta)


def test_bf16_shard_matches_jax_bytes():
    import jax.numpy as jnp
    x = np.asarray(jnp.asarray([[0.5, -1.25, 3.0]], jnp.bfloat16))
    meta = dict(key="k", step=1, dtype="bfloat16", shape=(1, 3),
                chunk_index=0, n_chunks=1, global_shape=(1, 3))
    words = x.view(np.uint16)
    raw = encode_shard(words, ShardMeta(**meta))
    assert raw == jckpt.encode_shard(x, jckpt.ShardMeta(**meta))
    mgr, stores, log = make_mgr()
    t = torch.tensor([[0.5, -1.25, 3.0]], dtype=torch.bfloat16)
    mgr.save(1, {"w": t}, sync=True)
    assert stores[0].get("step000000000001['w']/c0of1") == \
        jckpt.encode_shard(x, jckpt.ShardMeta(
            **dict(meta, key="step000000000001['w']/c0of1")))
    _, got, _ = mgr.restore({"w": t})
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], t)


def jax_mgr(chunks=1):
    stores = [jckpt.ObjectStore(f"store{i}") for i in range(3)]
    rstore = jckpt.ReplicatedStore(stores, write_quorum=2)
    dev = jcore.PMEMDevice(CAP + 4096, mode="strict")
    log = jcore.Log.create(dev, jcore.LogConfig(capacity=CAP))
    return jckpt.CheckpointManager(rstore, log, jckpt.CheckpointConfig(
        chunks_per_leaf=chunks)), stores, dev


def port_mgr(chunks=1):
    stores = [ObjectStore(f"store{i}") for i in range(3)]
    dev = PMEMDevice(CAP + 4096, mode="strict")
    log = Log.create(dev, LogConfig(capacity=CAP), device="cpu")
    return CheckpointManager(ReplicatedStore(stores, write_quorum=2), log,
                             CheckpointConfig(chunks_per_leaf=chunks)), \
        stores, dev


def test_save_async_snapshot_stays_put_and_matches_jax():
    """``save_async`` copies each host leaf once before it returns: leaves
    updated in place afterwards (while the save worker is still busy) do
    not reach the shards, which are the JAX package's bytes for the state
    as it was, and the restore gives that state back."""
    state = make_state(seed=8, dim=16)
    state["params"]["half"] = torch.from_numpy(
        np.random.default_rng(8).normal(size=(4, 6)).astype(np.float32)
    ).to(torch.bfloat16)
    saved = {"params": {k: (v.clone() if isinstance(v, torch.Tensor) else
                            {n: w.clone() for n, w in v.items()})
                        for k, v in state["params"].items()},
             "opt": {"mu": state["opt"]["mu"].copy()}, "step": state["step"]}
    tm, tstores, _ = port_mgr()
    gate = __import__("threading").Event()
    tm._save_pool.submit(gate.wait)        # hold the single save worker
    fut = tm.save_async(4, state, extra={"pos": 4})
    for _, leaf in leaf_paths(state["params"]):
        leaf.add_(1)                        # in place, after the snapshot
    state["opt"]["mu"] += 1
    gate.set()
    fut.result()
    jm, jstores, _ = jax_mgr()
    jsaved = numpy_state(saved)
    jsaved["params"]["half"] = np.asarray(
        jax.numpy.asarray(saved["params"]["half"].float().numpy(),
                          jax.numpy.bfloat16))
    jm.save(4, jsaved, extra={"pos": 4}, sync=True)
    for js, ts in zip(jstores, tstores):
        assert js.keys() == ts.keys()
        assert all(js.get(k) == ts.get(k) for k in js.keys())
    step, got, extra = tm.restore(saved)
    assert (step, extra) == (4, {"pos": 4})
    assert torch.equal(got["params"].pop("half"), saved["params"].pop("half"))
    assert_tree_equal(got, saved)
    tm.close()


@pytest.mark.parametrize("chunks", [1, 4])
def test_shards_and_manifests_are_byte_identical_to_jax(chunks):
    state = make_state(seed=5, dim=64)
    jm, jstores, _ = jax_mgr(chunks)
    tm, tstores, _ = port_mgr(chunks)
    for step in (1, 2):
        jm.save(step, numpy_state(state), extra={"pos": step}, sync=True)
        tm.save(step, state, extra={"pos": step}, sync=True)
    jm.journal({"note": "x"}, sync=True)
    tm.journal({"note": "x"}, sync=True)
    for js, ts in zip(jstores, tstores):
        assert js.keys() == ts.keys()
        assert all(js.get(k) == ts.get(k) for k in js.keys())
    assert list(tm.log.iter_records()) == list(jm.log.iter_records())


def test_port_restores_a_checkpoint_the_jax_package_wrote():
    state = make_state(seed=6)
    jm, jstores, jdev = jax_mgr()
    jm.save(8, numpy_state(state), extra={"data_pos": 99}, sync=True)
    survivor = jdev.crash(np.random.default_rng(1), keep_probability=0.5)
    stores = [ObjectStore(s.name) for s in jstores]
    for js, ts in zip(jstores, stores):
        for k in js.keys():
            ts.put(k, js.get(k))
    relog = Log.open(to_port(survivor), LogConfig(capacity=CAP),
                     device="cpu")
    mgr = CheckpointManager(ReplicatedStore(stores, write_quorum=2), relog)
    step, got, extra = mgr.restore(state)
    assert (step, extra) == (8, {"data_pos": 99})
    assert_tree_equal(got, state)


def test_jax_package_restores_a_checkpoint_the_port_wrote():
    state = make_state(seed=7)
    tm, tstores, tdev = port_mgr()
    tm.save(9, state, sync=True)
    survivor = tdev.crash(np.random.default_rng(2), keep_probability=0.5)
    stores = [jckpt.ObjectStore(s.name) for s in tstores]
    for ts, js in zip(tstores, stores):
        for k in ts.keys():
            js.put(k, ts.get(k))
    relog = jcore.Log.open(to_jax(survivor), jcore.LogConfig(capacity=CAP))
    mgr = jckpt.CheckpointManager(jckpt.ReplicatedStore(stores, 2), relog)
    step, got, _ = mgr.restore(numpy_state(state))
    assert step == 9
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(numpy_state(state))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
