"""Synthetic corpus: a Zipf-Markov language (copy of
``repro.data.synthetic``, which is framework-free; the port keeps its own
copy so it never imports the JAX package).

A vocabulary-V first-order Markov chain whose rows are Zipf-distributed with
random per-state permutations plus a low-rank "topic" component.  The
serving driver draws its prompts from it.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class ZipfMarkov:
    vocab: int = 199
    zipf_a: float = 1.3
    n_topics: int = 8
    topic_weight: float = 0.35
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V = self.vocab
        ranks = np.arange(1, V + 1, dtype=np.float64)
        zipf = ranks ** (-self.zipf_a)
        zipf /= zipf.sum()
        T = np.empty((V, V))
        for s in range(V):
            T[s] = zipf[rng.permutation(V)]
        A = rng.dirichlet(np.ones(self.n_topics), size=V)        # (V, K)
        Btm = rng.dirichlet(np.ones(V) * 0.05, size=self.n_topics)  # (K, V)
        T = (1 - self.topic_weight) * T + self.topic_weight * (A @ Btm)
        self.T = T / T.sum(-1, keepdims=True)
        self.pi = np.full(V, 1.0 / V)

    def sample(self, rng: np.random.Generator, length: int) -> np.ndarray:
        out = np.empty(length, np.int32)
        s = rng.choice(self.vocab, p=self.pi)
        for i in range(length):
            s = rng.choice(self.vocab, p=self.T[s])
            out[i] = s
        return out

    def batch_iter(self, batch: int, seq_len: int, seed: int = 0
                   ) -> Iterator[np.ndarray]:
        """Yields (batch, seq_len+1) int32 — inputs tokens[:, :-1],
        labels tokens[:, 1:]."""
        rng = np.random.default_rng(seed)
        while True:
            yield np.stack([self.sample(rng, seq_len + 1)
                            for _ in range(batch)])

    def prompts(self, n: int, length: int, seed: int = 100):
        rng = np.random.default_rng(seed)
        return [self.sample(rng, length).tolist() for _ in range(n)]
