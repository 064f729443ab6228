"""Synthetic LM data pipeline: deterministic, seekable, shardable (port of
``repro/data/tokens.py``, numpy only, so the same seed gives the same
sequences bit for bit).

Sequences come from a mixture of order-k Markov chains over the vocab —
learnable structure (so training loss demonstrably falls) without external
data.  Supports host-sharded loading: each host materializes only its
slice of the global batch.  Batches are numpy arrays; the train loop moves
them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class SyntheticLMData:
    vocab: int
    seq_len: int
    seed: int = 0
    branching: int = 32          # successor fan-out per state (lower=easier)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab
        # per-token successor tables (order-1 markov, sparse fan-out)
        self._succ = rng.integers(0, v, size=(v, self.branching))
        self._succ_p = rng.dirichlet(np.ones(self.branching) * 0.5, size=v)

    def sequence(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, idx))
        out = np.empty(self.seq_len + 1, np.int32)
        tok = int(rng.integers(self.vocab))
        for i in range(self.seq_len + 1):
            out[i] = tok
            k = rng.choice(self.branching, p=self._succ_p[tok])
            tok = int(self._succ[tok, k])
        return out

    def batch(self, step: int, batch_size: int, *,
              shard: int = 0, num_shards: int = 1) -> Dict[str, np.ndarray]:
        """Global batch `step`, local slice `shard` of `num_shards`."""
        if batch_size % num_shards:
            raise ValueError(f"batch_size {batch_size} is not a multiple of "
                             f"num_shards {num_shards}")
        local = batch_size // num_shards
        base = step * batch_size + shard * local
        seqs = np.stack([self.sequence(base + i) for i in range(local)])
        return {"tokens": seqs[:, :-1].astype(np.int32),
                "labels": seqs[:, 1:].astype(np.int32)}


def batch_iterator(data: SyntheticLMData, batch_size: int, *,
                   start_step: int = 0, shard: int = 0,
                   num_shards: int = 1) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield data.batch(step, batch_size, shard=shard,
                         num_shards=num_shards)
        step += 1
