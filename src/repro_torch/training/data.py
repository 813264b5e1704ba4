"""Synthetic token pipeline (the JAX package's ``repro.training.data``,
byte for byte: pure numpy, so the same ``(seed, step)`` gives the same
batch in both packages).

A deterministic, seekable stream of pseudo-corpus token batches. The
"corpus" is a Zipf-distributed unigram mix with injected n-gram structure
(so losses actually go down during the example train runs — pure uniform
noise would pin CE at ln(V)). Supports sharding the batch dimension for
data parallelism.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticTokenStream:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    ngram_order: int = 3
    zipf_a: float = 1.2

    def __post_init__(self) -> None:
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        # Zipf unigram distribution
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._unigram = (ranks ** -self.zipf_a) / np.sum(ranks ** -self.zipf_a)
        # deterministic "grammar": each token has a preferred successor
        self._succ = rng.integers(0, v, size=v)
        self._succ_p = 0.5  # P(next = succ[cur]); else unigram draw

    def batch(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        """Deterministic (tokens, labels) for a global step."""
        rng = np.random.default_rng((self.seed, step))
        B, S, v = self.batch_size, self.seq_len, self.vocab_size
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.choice(v, size=B, p=self._unigram)
        follow = rng.random((B, S)) < self._succ_p
        draws = rng.choice(v, size=(B, S), p=self._unigram)
        for t in range(S):
            toks[:, t + 1] = np.where(follow[:, t], self._succ[toks[:, t]], draws[:, t])
        return toks[:, :-1], toks[:, 1:]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
