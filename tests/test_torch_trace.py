"""The port's spans and counters on the CPU (``repro_torch.trace``).

The spans open only while a profiler runs, change no output bit when
they do, carry the port's module names with the nesting a reader of a
trace relies on (the remat recompute inside the backward, a backward op
linked to its forward op by ``sequence_nr``, the save's workers on their
own threads), and the counters count what they say."""

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.checkpoint import (CheckpointConfig, CheckpointManager,
                                    ObjectStore, ReplicatedStore)
from repro_torch.configs import reduced_config
from repro_torch.core import Log, LogConfig, PMEMDevice
from repro_torch.data import DataConfig, SyntheticDataset
from repro_torch.optim import OptConfig
from repro_torch.train.step import init_train_state, train_step
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaf_paths

CAP = 1 << 18
F = 4
OPT = OptConfig(name="adamw", lr=3e-3, warmup_steps=2, decay_steps=1000,
                clip_norm=1.0)


def profiler():
    """A CPU profile that records every thread's ranges."""
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))


def spans(prof, name=None):
    want = trace.PREFIX + (name or "")
    return [e for e in prof.events() if e.name.startswith(want)]


def ancestors(e):
    out = []
    while e.cpu_parent is not None:
        e = e.cpu_parent
        out.append(e.name)
    return out


def state_and_batch(arch, seed=0):
    cfg = reduced_config(arch)
    gen = torch.Generator().manual_seed(seed)
    state = init_train_state(cfg, OPT, gen, device="cpu")
    data = SyntheticDataset(cfg, DataConfig(batch=2, seq_len=64, seed=seed))
    return cfg, state, data.tensors_at(0, "cpu")


def clone(tree):
    return {k: clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def manager(log, threads=2):
    return CheckpointManager(
        ReplicatedStore([ObjectStore("s0"), ObjectStore("s1")],
                        write_quorum=2), log,
        CheckpointConfig(force_freq=F, writer_threads=threads))


def new_log():
    return Log.create(PMEMDevice(CAP + 4096, mode="fast"),
                      LogConfig(capacity=CAP), device="cpu")


def test_no_range_is_entered_without_a_profiler(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(trace, "_RecordFunctionFast", Counting)
    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        Counting)
    cfg, state, batch = state_and_batch("mamba2-130m")
    train_step(state, batch, cfg, OPT, journal=True, donate=True)
    assert entered == []
    assert trace.span("model.norm") is trace.span("step.forward")
    # the same step under a profiler enters the port's ranges
    with profile(activities=[ProfilerActivity.CPU]):
        train_step(state, batch, cfg, OPT, journal=True, donate=True)
    assert {"repro_torch.step.forward", "repro_torch.model.norm",
            "repro_torch.optim.apply_updates"} <= set(entered)
    assert all(n.startswith(trace.PREFIX) for n in entered)


@pytest.mark.parametrize("arch", ["mamba2-130m", "starcoder2-3b"])
def test_outputs_are_bitwise_the_same_with_a_profiler_on(arch):
    cfg, state, batch = state_and_batch(arch)
    runs = []
    for on in (False, True, False):
        s = clone(state)
        if on:
            with profiler() as prof:
                new, met = train_step(s, batch, cfg, OPT, journal=True,
                                      donate=True)
            assert spans(prof, "step.hash")
        else:
            new, met = train_step(s, batch, cfg, OPT, journal=True,
                                  donate=True)
        runs.append([t for _, t in leaf_paths(new)] +
                    [met[k] for k in sorted(met)])
    for other in runs[1:]:
        assert len(other) == len(runs[0])
        for a, b in zip(runs[0], other):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a.reshape(-1).view(torch.uint8),
                               b.reshape(-1).view(torch.uint8))


@pytest.fixture(scope="module")
def trainer_profile():
    """One profiled ``Trainer.run`` step that journals and starts a
    ``save_async`` of the whole state (F = 4, two writer threads)."""
    cfg = reduced_config("mamba2-130m")
    log = new_log()
    mgr = manager(log)
    data = SyntheticDataset(cfg, DataConfig(batch=2, seq_len=64))
    tr = Trainer(cfg, OPT, data, mgr,
                 TrainerConfig(total_steps=100, ckpt_every=2,
                               journal_freq=F, async_ckpt=True),
                 device="cpu")
    tr.init_or_restore()
    tr.run(1)
    forces = log.stats()["forces"]
    with profiler() as prof:
        tr.run(1)                          # step 1: journal, then the save
    forces = log.stats()["forces"] - forces
    mgr.close()
    return prof, forces


def test_a_trainer_step_holds_the_port_spans(trainer_profile):
    prof, _ = trainer_profile
    names = {e.name[len(trace.PREFIX):] for e in spans(prof)}
    assert {"trainer.data", "trainer.sync", "step.forward", "step.backward",
            "step.hash", "optim.apply_updates", "model.embed", "model.cast",
            "model.norm", "model.mixer.ssm", "model.logits", "model.loss",
            "ckpt.snapshot", "ckpt.encode", "ckpt.put", "ckpt.manifest",
            "log.force"} <= names
    pre = trace.PREFIX
    for e in spans(prof, "model."):
        up = ancestors(e)
        assert pre + "step.forward" in up or pre + "step.backward" in up
    for e in spans(prof, "optim.") + spans(prof, "step."):
        assert not any(a.startswith(pre + "model.") for a in ancestors(e))
    main = {e.thread for e in spans(prof, "step.forward")}
    # the shard work runs on the manager's writer threads
    assert {e.thread for e in spans(prof, "ckpt.encode")} - main
    assert {e.thread for e in spans(prof, "ckpt.snapshot")} == main


def test_remat_recompute_opens_model_spans_in_the_backward(trainer_profile):
    prof, _ = trainer_profile
    pre = trace.PREFIX
    forward = [e for e in spans(prof, "model.mixer.ssm")
               if pre + "step.forward" in ancestors(e)]
    recomputed = [e for e in spans(prof, "model.mixer.ssm")
                  if pre + "step.forward" not in ancestors(e)]
    assert len(forward) == len(recomputed) == 1
    # the recompute runs inside an autograd node's evaluation
    assert any(a.startswith("autograd::engine::evaluate_function")
               for a in ancestors(recomputed[0]))


def test_a_backward_op_links_to_its_forward_op_under_a_norm(trainer_profile):
    prof, _ = trainer_profile
    pre = trace.PREFIX
    node = "autograd::engine::evaluate_function"
    forward = {}
    for e in prof.events():
        if e.sequence_nr >= 0 and not any(
                a.startswith(node) for a in [e.name] + ancestors(e)):
            forward.setdefault((e.thread, e.sequence_nr), e)
    linked = []
    for e in prof.events():
        if e.name.startswith(node) and e.sequence_nr >= 0:
            fwd = forward.get((e.fwd_thread, e.sequence_nr))
            if fwd is not None and pre + "model.norm" in ancestors(fwd):
                linked.append((e.name, fwd.name))
    assert linked, "no backward op links to a forward op under model.norm"


def test_log_force_spans_are_the_rounds_the_counter_counts(trainer_profile):
    prof, forces = trainer_profile
    assert forces >= 1
    assert len(spans(prof, "log.force")) == forces


def test_log_force_opens_only_on_every_fth_append():
    log = new_log()
    with profiler() as prof:
        for i in range(3 * F):
            log.append(b"record %d" % i, freq=F)
    assert len(spans(prof, "log.force")) == 3
    assert log.stats()["forces"] == 3 and log.stats()["force_s"] > 0


def test_counters_count_what_they_say():
    log = new_log()
    mgr = manager(log)
    for i in range(2 * F):
        mgr.journal({"step": i, "loss": 1.0})
    assert log.stats()["forces"] == 2
    cfg, state, _ = state_and_batch("mamba2-130m")
    state["extra"] = np.arange(5, dtype=np.int64)
    mgr.save_async(1, state).result()
    want = sum(t.nbytes for _, t in leaf_paths(state))
    assert mgr.stats()["snapshot_bytes"] == want
    assert mgr.stats()["snapshot_s"] > 0
    mgr.close()
    data = SyntheticDataset(cfg, DataConfig(batch=2, seq_len=64))
    tr = Trainer(cfg, OPT, data, manager(new_log()),
                 TrainerConfig(total_steps=2, ckpt_every=100,
                               async_ckpt=False), device="cpu")
    tr.init_or_restore()
    assert tr.report.data_s == 0.0
    tr.run()
    assert tr.report.data_s > 0
    tr.mgr.close()
