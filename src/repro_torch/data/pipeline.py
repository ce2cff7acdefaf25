"""Deterministic, shard-aware, resumable synthetic token pipeline.

The port's copy of ``repro.data.pipeline``: NumPy only, unchanged, so its
batches equal the reference's bit for bit.

Every (step, dp_rank) pair maps to an independent counter-based seed, so:
  * restarts resume exactly (state == step index, nothing else);
  * each data-parallel rank draws a disjoint stream (no host coordination);
  * elastic rescaling re-partitions the same global stream deterministically
    (global sample index = step * global_batch + position).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "TokenPipeline"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # markov-ish structure so the loss has signal to minimize
    n_states: int = 64


class TokenPipeline:
    def __init__(self, cfg: DataConfig, dp_rank: int = 0, dp_size: int = 1,
                 start_step: int = 0):
        assert cfg.global_batch % dp_size == 0
        self.cfg = cfg
        self.dp_rank = dp_rank
        self.dp_size = dp_size
        self.step = start_step
        self.local_batch = cfg.global_batch // dp_size
        # fixed per-state emission tables (same on every rank; derived from seed)
        rng = np.random.default_rng(cfg.seed)
        self._emit = rng.integers(
            0, cfg.vocab_size, size=(cfg.n_states, 8), dtype=np.int64
        )
        self._trans = rng.integers(
            0, cfg.n_states, size=(cfg.n_states, 4), dtype=np.int64
        )

    def state(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    @classmethod
    def restore(cls, cfg: DataConfig, state: dict, dp_rank=0, dp_size=1):
        assert state["seed"] == cfg.seed, "restoring against a different stream"
        return cls(cfg, dp_rank, dp_size, start_step=state["step"])

    def _sample(self, global_idx: int) -> np.ndarray:
        rng = np.random.default_rng((self.cfg.seed, global_idx))
        s = int(rng.integers(0, self.cfg.n_states))
        out = np.empty(self.cfg.seq_len + 1, dtype=np.int64)
        for t in range(self.cfg.seq_len + 1):
            out[t] = self._emit[s, rng.integers(0, 8)]
            s = int(self._trans[s, rng.integers(0, 4)])
        return out

    def next_batch(self) -> dict:
        """Returns {'tokens','labels'} of shape (local_batch, seq_len)."""
        base = self.step * self.cfg.global_batch + self.dp_rank * self.local_batch
        seqs = np.stack([self._sample(base + i) for i in range(self.local_batch)])
        self.step += 1
        return {
            "tokens": seqs[:, :-1].astype(np.int32),
            "labels": seqs[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()
