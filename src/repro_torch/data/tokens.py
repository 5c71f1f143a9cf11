"""Deterministic, shard-aware, resumable synthetic token pipeline.

A copy of ``repro.data.tokens`` (numpy only; the port imports nothing of
the JAX package).  Every batch is a pure function of (seed, step, shard),
so

* exact resume after restart = just set step (no iterator state to save),
* each host generates only its shard (no cross-host IO),
* straggler "backup tasks": any host can regenerate any shard.

The stream has learnable structure (an order-1 latent-regime Markov chain
over token deltas), so the train example shows real loss descent, not
noise-floor flatlines.  Both packages draw the same numbers in the same
order, so their batches are bitwise equal.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    n_regimes: int = 8

    def batch_for_step(self, step: int, *, shard: int = 0,
                       n_shards: int = 1) -> Dict[str, np.ndarray]:
        """{"tokens","labels"}: (B/n_shards, S) int32, labels = next token."""
        if self.global_batch % n_shards:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split into {n_shards} shards")
        b = self.global_batch // n_shards
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 131 + shard)
        v = self.vocab_size
        regimes = rng.integers(1, 17, size=(self.n_regimes,))
        seq = np.empty((b, self.seq_len + 1), np.int64)
        seq[:, 0] = rng.integers(0, v, size=(b,))
        regime = rng.integers(0, self.n_regimes, size=(b,))
        for t in range(1, self.seq_len + 1):
            switch = rng.random(b) < 0.05
            regime = np.where(switch, rng.integers(0, self.n_regimes,
                                                   size=(b,)), regime)
            noise = rng.integers(0, 3, size=(b,))
            seq[:, t] = (seq[:, t - 1] + regimes[regime] + noise) % v
        return {"tokens": seq[:, :-1].astype(np.int32),
                "labels": seq[:, 1:].astype(np.int32)}

    def frames_for_step(self, step: int, d_model: int, *, shard: int = 0,
                        n_shards: int = 1, dtype=np.float32) -> np.ndarray:
        """Stub modality frontend: deterministic frame embeddings."""
        b = self.global_batch // n_shards
        rng = np.random.default_rng(
            (self.seed * 7_000_003 + step) * 131 + shard)
        return rng.standard_normal((b, self.seq_len, d_model)).astype(dtype)
