"""Plain PageRank: float64 power iteration over the whole edge list.

Independent of the program: it reads the edge list and the out-degrees
the benchmark drew, nothing the program computed.  ``dtype`` lower than
float64 is the control: the same iteration with the rank vector and the
per-edge products rounded to that type (sums in float32).
"""
from __future__ import annotations

import torch


def pagerank(src: torch.Tensor, dst: torch.Tensor, inv_outdeg: torch.Tensor,
             n: int, rounds: int, damping: float,
             dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Scores after ``rounds`` rounds from the uniform vector: ``p = (1 -
    d) / n + d * sum over edges (s -> t) of p[s] / outdeg(s)``.  Vertices
    with no in-edge keep the teleport mass; mass of vertices with no
    out-edge is not redistributed (as the paper's iteration)."""
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    w = inv_outdeg.to(dtype)
    p = torch.full((n,), 1.0 / n, dtype=torch.float64, device=src.device)
    for _ in range(rounds):
        contrib = (p.to(dtype)[src] * w).to(acc)
        q = torch.zeros(n, dtype=acc, device=src.device).index_add_(
            0, dst, contrib)
        p = ((1.0 - damping) / n + damping * q.to(torch.float64))
        p = p.to(dtype).to(torch.float64)
    return p


def assemble(out_idx: torch.Tensor, partial: torch.Tensor, n: int,
             damping: float) -> torch.Tensor:
    """Global scores from every node's final partial products ``partial``
    (laid end to end in the order of the nodes' out-sets ``out_idx``):
    the teleport once plus the damped sum over nodes, in float64."""
    q = torch.zeros(n, dtype=torch.float64, device=partial.device)
    q.index_add_(0, out_idx, partial.to(torch.float64))
    return (1.0 - damping) / n + damping * q


def max_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest ``|got - want| / want`` over the vertices (every score is
    at least the teleport mass, so never 0)."""
    return float(((got - want).abs() / want).max())
