"""Synthetic power-law graphs (reference: ``repro.data.pipeline``).

A short numpy copy of the reference's graph half: ``powerlaw_graph``
(Chung-Lu style power-law edge list) and ``random_edge_partition`` (the
paper's §II-B random edge partition).  Equal seeds give the reference's
exact edges and partitions.
"""
from __future__ import annotations

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
