"""Deterministic synthetic data pipelines, sharded per host (the port's
copy of ``repro.data.pipeline``, which is pure numpy: each stream gives
bitwise the same batch as JAX's for a given ``(seed, step, shard)``).

Every stream is a pure function of (seed, step, shard) — restart-safe (resume
at any step without replaying) and host-parallel (each host generates only
its shard; no data redistribution collective needed at scale).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenStream:
    """LM token batches [B, S+1] (inputs = [:, :-1], labels = [:, 1:]).

    Markov-chain tokens (order-1, banded transition) rather than uniform —
    gives a learnable signal so example runs show loss descending."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    shard: int = 0
    n_shards: int = 1

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.n_shards == 0
        return self.global_batch // self.n_shards

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.shard
        )
        B, S = self.local_batch, self.seq_len
        # banded markov walk over the vocab
        start = rng.integers(0, self.vocab, size=(B, 1))
        steps = rng.integers(-8, 9, size=(B, S))
        toks = (start + np.cumsum(steps, axis=1)) % self.vocab
        toks = np.concatenate([start, toks], axis=1).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclasses.dataclass(frozen=True)
class RecsysStream:
    """Criteo-like batches: 13 dense + 26 categorical + click label with a
    planted logistic rule (learnable)."""

    field_vocabs: tuple
    global_batch: int
    n_dense: int = 13
    seed: int = 0
    shard: int = 0
    n_shards: int = 1

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.seed * 999_983 + step) * 65_537 + self.shard
        )
        B = self.global_batch // self.n_shards
        dense = rng.lognormal(0.0, 2.0, size=(B, self.n_dense)).astype(
            np.float32
        )
        sparse = np.stack(
            [rng.integers(0, v, size=B) for v in self.field_vocabs], axis=1
        ).astype(np.int32)
        logit = (
            0.05 * dense[:, 0]
            - 0.04 * dense[:, 1]
            + 0.3 * ((sparse[:, 0] % 7) == 3)
            - 0.2 * ((sparse[:, 1] % 5) == 1)
        )
        p = 1 / (1 + np.exp(-logit))
        labels = (rng.random(B) < p).astype(np.int32)
        return {"dense": dense, "sparse": sparse, "labels": labels}


@dataclasses.dataclass(frozen=True)
class GraphSeedStream:
    """Seed-node batches for sampled GNN training."""

    n_nodes: int
    batch_nodes: int
    n_classes: int = 40
    seed: int = 0
    shard: int = 0
    n_shards: int = 1

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.seed * 424_243 + step) * 65_537 + self.shard
        )
        B = self.batch_nodes // self.n_shards
        seeds = rng.integers(0, self.n_nodes, size=B).astype(np.int32)
        labels = (seeds % self.n_classes).astype(np.int32)  # learnable rule
        return {"seeds": seeds, "labels": labels}
