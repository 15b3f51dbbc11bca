"""Synthetic token data pipeline (NumPy copy of ``repro.data.synthetic``).

Deterministic, seekable token stream. Sequences are drawn from a mixture
of Markov-chain "tasks" so the data has learnable structure, and carry
the same task-type annotation the serving workload uses; here it feeds
``data.predictor.calibrate_from_synthetic``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    n_tasks: int = 6
    seed: int = 0
    order: int = 1           # Markov order


class SyntheticTokens:
    """Mixture of per-task Markov chains over the model vocabulary."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = min(cfg.vocab_size, 128)        # transition table cap
        self._v = v
        # per-task sparse-ish transition tables with distinct structure
        self._tables = []
        for k in range(cfg.n_tasks):
            logits = rng.normal(size=(v, v)) * 0.5
            # bias toward a task-specific cyclic structure
            shift = (k * 7 + 1) % v
            idx = (np.arange(v) + shift) % v
            logits[np.arange(v), idx] += 5.0   # strongly structured
            p = np.exp(logits - logits.max(-1, keepdims=True))
            self._tables.append(p / p.sum(-1, keepdims=True))

    def batch(self, step: int) -> dict:
        """Deterministic batch for a global step (seekable/resumable)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S = cfg.batch_size, cfg.seq_len
        tasks = rng.integers(0, cfg.n_tasks, size=B)
        toks = np.zeros((B, S + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, self._v, size=B)
        for b in range(B):
            table = self._tables[tasks[b]]
            u = rng.random((S,))
            cum = np.cumsum(table, axis=1)
            t = toks[b, 0]
            for s in range(S):
                t = int(np.searchsorted(cum[t], u[s]))
                t = min(t, self._v - 1)
                toks[b, s + 1] = t
        return {"tokens": toks, "tasks": tasks}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
