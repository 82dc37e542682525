"""Traffic generation, frozen inside the benchmark.

``SyntheticDataset`` is a copy of the port's
``repro_torch/data/pipeline.py::SyntheticDataset`` as it stood when the
benchmark was defined (its token inputs; the frame and patch inputs no
cell uses are left out): each ``Trainer`` is given this copy, so a change
to the program's pipeline does not move the yardstick.  Batches are a
pure function of (seed, step).

``prompt_plan`` and ``prompts`` are the prefill mix: a fixed multiset of
prompt lengths, replayed cycle after cycle in an order the seed shuffles,
so the seed changes the order and the tokens, never the work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np
import torch


@dataclass
class DataConfig:
    seed: int = 0
    batch: int = 8
    seq_len: int = 128
    markov_jump: int = 7          # next ~= (tok * jump + 1) % vocab
    noise: float = 0.1


class SyntheticDataset:
    """A noisy Markov chain of tokens, next-token labels (last position
    ignored); the interface the port's ``Trainer`` drives."""

    def __init__(self, model_cfg, cfg: DataConfig):
        self.mcfg = model_cfg
        self.cfg = cfg
        self.step = 0

    def state(self) -> Dict[str, Any]:
        return {"seed": self.cfg.seed, "step": self.step}

    def restore(self, state: Dict[str, Any]) -> None:
        if state["seed"] != self.cfg.seed:
            raise ValueError(f"seed mismatch on restore: {state['seed']} != "
                             f"{self.cfg.seed}")
        self.step = int(state["step"])

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step]))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg, m = self.cfg, self.mcfg
        rng = self._rng(step)
        B, S, V = cfg.batch, cfg.seq_len, m.vocab_size
        toks = np.empty((B, S), np.int64)
        toks[:, 0] = rng.integers(0, V, B)
        noise = rng.random((B, S)) < cfg.noise
        rand = rng.integers(0, V, (B, S))
        for t in range(1, S):
            nxt = (toks[:, t - 1] * cfg.markov_jump + 1) % V
            toks[:, t] = np.where(noise[:, t], rand[:, t], nxt)
        labels = np.full((B, S), -1, np.int64)
        labels[:, :S - 1] = toks[:, 1:]
        return {"tokens": toks.astype(np.int32),
                "labels": labels.astype(np.int32)}

    def tensors_at(self, step: int, device) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(device=device, dtype=torch.int64)
                for k, v in self.batch_at(step).items()}


def prompt_plan(lengths: List[int], cycles: int, seed: int) -> List[int]:
    """The prompt length of every batch: ``cycles`` passes over the
    multiset ``lengths``, each in an order drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x5EED]))
    return [int(v) for _ in range(cycles)
            for v in rng.permutation(np.asarray(lengths))]


def prompts(seed: int, index: int, batch: int, length: int, vocab: int,
            device) -> torch.Tensor:
    """Batch ``index``'s prompts [batch, length]: token ids drawn on
    ``device`` by a generator seeded from (seed, index)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, index, 0x7A11])
                      .generate_state(1, np.uint64)[0] >> 1))
    return torch.randint(0, vocab, (batch, length), generator=g,
                         device=device)
