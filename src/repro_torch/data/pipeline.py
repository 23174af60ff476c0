"""Deterministic synthetic data pipeline: resumable, shardable, seeded.

Produces a Zipf-ish token stream with learnable bigram structure (so tiny
models show decreasing loss), keyed purely on (seed, step) — restart at step k
regenerates the identical batch, which the checkpoint-restart test relies on.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0


class SyntheticLM:
    """Markov-chain token generator with a fixed random transition structure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # sparse-ish bigram preference: each token has 4 likely successors
        self._succ = rng.integers(0, cfg.vocab, size=(cfg.vocab, 4))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed << 20) ^ step)
        B, S = cfg.batch, cfg.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab, size=B)
        explore = rng.random((B, S)) < 0.15
        choice = rng.integers(0, 4, size=(B, S))
        rand_tok = rng.integers(0, cfg.vocab, size=(B, S))
        for t in range(S):
            nxt = self._succ[toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(explore[:, t], rand_tok[:, t], nxt)
        return {"tokens": toks[:, :S], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_batch(cfg: ModelConfig, batch: int, seq_len: int, step: int,
               seed: int = 0) -> Dict[str, np.ndarray]:
    """Family-aware batch (adds stub frontend features where needed)."""
    if cfg.family == "encdec":
        half = seq_len // 2
        lm = SyntheticLM(DataConfig(cfg.vocab, batch, half, seed))
        b = lm.batch_at(step)
        rng = np.random.default_rng(step + 1)
        return {
            "frames": rng.standard_normal((batch, half, cfg.frontend_dim)).astype(np.float32),
            "tokens": b["tokens"],
            "labels": b["labels"],
        }
    if cfg.frontend == "vision":
        text = seq_len - cfg.n_patches
        lm = SyntheticLM(DataConfig(cfg.vocab, batch, text, seed))
        b = lm.batch_at(step)
        rng = np.random.default_rng(step + 1)
        b["patches"] = rng.standard_normal(
            (batch, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
        return b
    lm = SyntheticLM(DataConfig(cfg.vocab, batch, seq_len, seed))
    return lm.batch_at(step)
