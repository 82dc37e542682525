"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped, the rest of a run driven on the
CPU at a tiny size, with each fault the cell can have planted where the
program produces its answer."""

import pytest
import torch

from .common import TINY, run_tiny

TRAIN = ["mamba2-130m.train", "starcoder2-3b.train",
         "mamba2-130m.train-ckpt"]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def unchanged(step):
    """The step computes its grads, hashes and loss, and returns the state
    it was given (its step count advanced)."""
    def f(state, batch):
        _, met = step(_clone(state), batch)
        return {**state, "step": state["step"] + 1}, met
    return f


def half_batch(step):
    return lambda state, batch: step(
        state, {k: v[:v.shape[0] // 2] for k, v in batch.items()})


def loss_shift(step):
    def f(state, batch):
        new, met = step(state, batch)
        return new, {**met, "loss": met["loss"] + 0.05}
    return f


def integrity_shift(step):
    def f(state, batch):
        new, met = step(state, batch)
        return new, {**met, "integrity": met["integrity"] ^ 1}
    return f


def token_shift(serve):
    vocab = TINY["mamba2-130m.prefill"][0]["vocab_size"]
    return lambda prompts: (serve(prompts) + 1) % vocab


def half_served(serve):
    return lambda prompts: serve(prompts)[:prompts.shape[0] // 2]


TRAIN_FAULTS = {
    "a step that returns its state unchanged": unchanged,
    "half of the batch left out, the mean over the rest": half_batch,
    "the step's loss altered where it is produced": loss_shift,
    "the step's integrity record altered where it is produced":
        integrity_shift,
}
PREFILL_FAULTS = {
    "a served token altered where it is produced": token_shift,
    "half of the batch left out": half_served,
}


@pytest.mark.parametrize("name", TRAIN + ["mamba2-130m.prefill"])
def test_sound_run_is_correct(name):
    out = run_tiny(name)
    assert out.correct, out.checks


@pytest.mark.parametrize("fault", list(TRAIN_FAULTS))
@pytest.mark.parametrize("name", TRAIN)
def test_train_fault_is_caught(name, fault):
    out = run_tiny(name, TRAIN_FAULTS[fault])
    assert not out.correct, out.checks


@pytest.mark.parametrize("fault", list(PREFILL_FAULTS))
def test_prefill_fault_is_caught(fault):
    out = run_tiny("mamba2-130m.prefill", PREFILL_FAULTS[fault])
    assert not out.correct, out.checks
