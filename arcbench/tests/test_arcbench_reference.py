"""The plain reference against the port's CPU path at tiny widths, in
float32: the forward's logits, and the first steps of training."""

import pytest
import torch

from arcbench.harness import deploy, traffic, weights
from arcbench.reference import model as ref
from arcbench.reference import train as ref_train

from .common import SEED, TINY, tiny_cell

FP32 = dict(param_dtype="float32", compute_dtype="float32")


@pytest.mark.parametrize("name", ["mamba2-130m.train",
                                  "starcoder2-3b.train"])
def test_forward_matches_the_port(name):
    from repro_torch.models import model as M
    cell = tiny_cell(name)
    over = {**TINY[name][0], **FP32}
    cfg = deploy.model_config(cell.config, over)
    w = weights.make(weights.port_specs(cfg), SEED, "cpu")
    tokens = torch.randint(0, over["vocab_size"], (2, 64),
                           generator=torch.Generator().manual_seed(1))
    want = ref.logits(w, {**cell.config["model"], **over}, tokens, ref.Ops())
    got, _ = M.serve_step(weights.as_tree(w, cfg), cfg, {"tokens": tokens},
                          None, None)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["mamba2-130m.train",
                                  "starcoder2-3b.train"])
def test_training_matches_the_port(name):
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.train import step as S
    from repro_torch.tree import leaf_paths
    cell = tiny_cell(name)
    over = {**TINY[name][0], **FP32}
    cfg = deploy.model_config(cell.config, over)
    specs = weights.port_specs(cfg)
    o = cell.config["deployment"]["optimizer"]
    data = traffic.SyntheticDataset(cfg, traffic.DataConfig(
        seed=SEED, batch=2, seq_len=64))
    batches = [data.tensors_at(s, "cpu") for s in range(3)]
    params = weights.as_tree(weights.make(specs, SEED, "cpu"), cfg)
    opt = OptConfig(**o)
    state = {"params": params, "opt": init_opt_state(params, opt),
             "step": torch.zeros((), dtype=torch.int32)}
    losses = []
    for i, b in enumerate(batches):
        state, met = S.train_step(state, b, cfg, opt, journal=True,
                                  donate=True)
        losses.append(float(met["loss"]))
        if i == 0:
            first = {n: float(m.norm()) / (1 - o["b1"])
                     for n, m in _m(state["opt"])}
    start = weights.make(specs, SEED, "cpu")
    change = {n: float((p - start[n]).norm())
              for n, p in leaf_paths(state["params"])}
    want = ref_train.follow(lambda: weights.make(specs, SEED, "cpu"),
                            {**cell.config["model"], **over}, batches, o,
                            ref.Ops(), rows=1)
    g = ref_train.gaps({"losses": losses, "first_grad": first,
                        "change": change}, want)
    assert g["loss_gap"] < 1e-5
    assert g["grad_gap"] < 1e-4
    assert g["change_gap"] < 1e-3


def _m(opt_tree, prefix=""):
    """(param name, m) of the AdamW state tree."""
    if set(opt_tree) == {"m", "v"} and isinstance(opt_tree["m"],
                                                   torch.Tensor):
        yield prefix, opt_tree["m"]
        return
    for k in sorted(opt_tree):
        yield from _m(opt_tree[k], f"{prefix}[{k!r}]")


def test_plain_hash_matches_the_port():
    from repro_torch.kernels.checksum import ref as port_hash
    from arcbench.reference import hash as plain
    g = torch.Generator().manual_seed(3)
    for shape, dt in (((5,), torch.float32), ((3, 7), torch.bfloat16),
                      ((5000, 3), torch.float32)):
        x = torch.randn(shape, generator=g).to(dt)
        assert plain.tensor_hash(x) == int(port_hash.tensor_checksum(x))
    old = plain.PIECE
    try:
        plain.PIECE = 64
        x = torch.randn(1000, generator=g)
        assert plain.tensor_hash(x) == int(port_hash.tensor_checksum(x))
    finally:
        plain.PIECE = old


def test_log_reader_reads_the_journal_from_every_copy():
    from arcbench.reference import logread
    cell = tiny_cell("mamba2-130m.train")
    d = deploy.Deployment(cell.config, "cpu")
    try:
        records = [{"step": s, "loss": 10.0 - s / 7} for s in range(40)]
        for r in records:
            d.mgr.journal(r)
        d.mgr.log.force(d.mgr.log.next_lsn - 1, freq=1)
        images = d.images()
        assert len(images) == 2
        assert logread.missing(images, records) == 0
        assert logread.missing(images, records + [{"step": 99}]) == 2
        # a flipped payload byte fails its CRC on that copy
        name, img = images[1]
        at = img.find(b'"step": 7,')
        bad = img[:at] + b"X" + img[at + 1:]
        assert logread.missing([(name, bad)], records) == 1
    finally:
        d.close()
