"""Deterministic, checkpointable synthetic data pipeline (the JAX package's
``data/pipeline.py``, numpy only, copied so that the port imports nothing
of it).

Batches are a pure function of (seed, step): resuming from a journaled
step reproduces the exact token stream, which is what makes the journal's
recovery *exact* (the trainer journals the data position each step and
replays from the restored one).  The token stream has learnable structure
(a noisy Markov chain) so smoke training reduces the loss.  ``batch_at``
gives the numpy arrays, equal array for array to the JAX package's;
``tensors_at`` turns them into tensors on the trainer's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from ..models.config import ModelConfig


@dataclass
class DataConfig:
    seed: int = 0
    batch: int = 8
    seq_len: int = 128
    markov_jump: int = 7          # next ~= (tok * jump + 1) % vocab
    noise: float = 0.1


class SyntheticDataset:
    def __init__(self, model_cfg: ModelConfig, cfg: DataConfig):
        self.mcfg = model_cfg
        self.cfg = cfg
        self.step = 0

    # -- checkpointable state -------------------------------------------- #
    def state(self) -> Dict[str, Any]:
        return {"seed": self.cfg.seed, "step": self.step}

    def restore(self, state: Dict[str, Any]) -> None:
        if state["seed"] != self.cfg.seed:
            raise ValueError(f"seed mismatch on restore: {state['seed']} != "
                             f"{self.cfg.seed}")
        self.step = int(state["step"])

    # -- batches ----------------------------------------------------------- #
    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step]))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg, m = self.cfg, self.mcfg
        rng = self._rng(step)
        B, S, V = cfg.batch, cfg.seq_len, m.vocab_size
        out: Dict[str, np.ndarray] = {}
        if m.input_kind == "frames":
            out["frames"] = rng.normal(
                size=(B, S, m.frontend_dim)).astype(np.float32)
            out["labels"] = rng.integers(0, V, (B, S)).astype(np.int32)
            return out
        npatch = m.n_patches if m.input_kind == "tokens+patches" else 0
        s_txt = S - npatch
        toks = np.empty((B, s_txt), np.int64)
        toks[:, 0] = rng.integers(0, V, B)
        noise = rng.random((B, s_txt)) < cfg.noise
        rand = rng.integers(0, V, (B, s_txt))
        for t in range(1, s_txt):
            nxt = (toks[:, t - 1] * cfg.markov_jump + 1) % V
            toks[:, t] = np.where(noise[:, t], rand[:, t], nxt)
        out["tokens"] = toks.astype(np.int32)
        if npatch:
            out["patches"] = rng.normal(
                size=(B, npatch, m.frontend_dim)).astype(np.float32)
        labels = np.full((B, S), -1, np.int64)
        # next-token prediction on the text span (last position ignored)
        labels[:, npatch:S - 1] = toks[:, 1:]
        out["labels"] = labels.astype(np.int32)
        return out

    def tensors_at(self, step: int, device) -> Dict[str, torch.Tensor]:
        """``batch_at(step)`` as tensors on ``device``: token ids and labels
        as int64 (torch's index type), embeddings as fp32."""
        return {k: torch.from_numpy(v).to(device=device,
                                          dtype=torch.int64
                                          if v.dtype == np.int32 else None)
                for k, v in self.batch_at(step).items()}

    def next_batch(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self.step)
        self.step += 1
        return b
