"""Synthetic power-law data (reference: ``repro.data.pipeline``).

A numpy copy of the reference: ``powerlaw_graph`` (Chung-Lu style
power-law edge list), ``random_edge_partition`` (the paper's §II-B random
edge partition), ``zipf_tokens`` (Zipf token ids, the language-model
stream) and ``Batcher`` (a deterministic minibatch iterator).  Equal
seeds give the reference's exact edges, partitions and batches.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


def powerlaw_graph(n_vertices: int, n_edges: int, alpha: float = 2.0,
                   seed: int = 0) -> np.ndarray:
    """Edge list [E, 2] with power-law degree distribution (Chung-Lu);
    self-loops are dropped, so E <= n_edges."""
    rng = np.random.RandomState(seed)
    w = (np.arange(1, n_vertices + 1, dtype=np.float64)) ** (-1.0 / (alpha - 1))
    p = w / w.sum()
    src = rng.choice(n_vertices, size=n_edges, p=p).astype(np.int64)
    dst = rng.choice(n_vertices, size=n_edges, p=p).astype(np.int64)
    keep = src != dst
    edges = np.stack([src[keep], dst[keep]], axis=1)
    # spread hubs over the id space (raw ids should not be degree-sorted)
    perm = rng.permutation(n_vertices).astype(np.int64)
    return perm[edges]


def random_edge_partition(edges: np.ndarray, num_parts: int,
                          seed: int = 0) -> list:
    """Paper §II-B: random edge partition across machines."""
    rng = np.random.RandomState(seed)
    part = rng.randint(0, num_parts, size=len(edges))
    return [edges[part == i] for i in range(num_parts)]


def zipf_tokens(rng: np.random.RandomState, shape, vocab: int,
                alpha: float = 1.2) -> np.ndarray:
    """Zipf(alpha) token ids in [0, vocab) by inverse-CDF sampling over
    ranks, spread over the id space by a random permutation (the
    reference's draws, byte for byte)."""
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    w = ranks ** (-alpha)
    cdf = np.cumsum(w) / np.sum(w)
    u = rng.random_sample(int(np.prod(shape)))
    ids = np.searchsorted(cdf, u).astype(np.int32)
    perm = rng.permutation(vocab).astype(np.int32)
    return perm[ids].reshape(shape)


@dataclasses.dataclass
class Batcher:
    """Deterministic infinite minibatch iterator: ``(tokens, labels)``
    int32 [batch, seq], labels the tokens shifted by one."""
    vocab: int
    batch: int
    seq: int
    alpha: float = 1.2
    seed: int = 0

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        rng = np.random.RandomState(self.seed)
        while True:
            toks = zipf_tokens(rng, (self.batch, self.seq + 1), self.vocab,
                               self.alpha)
            yield toks[:, :-1], toks[:, 1:]
