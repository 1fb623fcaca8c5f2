"""Traffic generation, from the seed, on the device where it is large.

Frozen copies of the program's generators, redrawn with a
``torch.Generator`` so that any seed (also one past 2**32) gives the same
inputs on the same device:

- :func:`powerlaw_edges`: the Chung-Lu power-law edge list of
  ``repro_torch.data.pipeline.powerlaw_graph`` (weights ``k ** (-1 / (alpha
  - 1))`` by rank, self-loops dropped, ids spread by a permutation);
- :func:`edge_partition`: the paper's random edge partition (§II-B) and
  each node's index sets and local positions (``graph.pagerank.
  build_partitions``), computed on the device;
- :func:`rank_cdf` / :func:`draw_ranks`: the graph's rank law, whose
  draws are also a mini-batch's indices (the endpoints of edges drawn as
  the graph's are);
- :func:`hashed_layout`: ids hashed by an affine-xor bijection of the
  32-bit index space (``core.sparse_vec.HashPerm``'s arithmetic),
  coalesced per node, sorted and SENTINEL-padded, as ``chip_smoke.
  union_wire_inputs`` lays them out;
- :func:`zipf_tokens`: Zipf token ids spread over the vocabulary
  (``data.pipeline.zipf_tokens``).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

SENTINEL = (1 << 32) - 1
_KNUTH = 2654435761


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for one named stream of a seed: streams
    keep the draws of independent inputs apart."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) \
        % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)


def draw_ranks(cdf: torch.Tensor, n: int, gen: torch.Generator) -> torch.Tensor:
    """``n`` int64 draws by inverse CDF: the first bin whose CDF reaches a
    uniform draw."""
    u = torch.rand(n, generator=gen, dtype=torch.float64, device=cdf.device)
    return torch.clamp(torch.searchsorted(cdf, u), max=cdf.numel() - 1)


def rank_cdf(n_vertices: int, alpha: float, device) -> torch.Tensor:
    """float64 CDF over ranks 1..n of the Chung-Lu weights ``k ** (-1 /
    (alpha - 1))``: the law of each end of an edge of a power-law graph
    whose degrees follow exponent ``alpha``."""
    w = torch.arange(1, n_vertices + 1, dtype=torch.float64, device=device) \
        ** (-1.0 / (alpha - 1.0))
    cdf = torch.cumsum(w, 0)
    return cdf / cdf[-1].clone()


def powerlaw_edges(n_vertices: int, n_edges: int, alpha: float,
                   gen: torch.Generator) -> torch.Tensor:
    """int64 [E, 2] (src, dst) with E <= n_edges: both ends drawn from
    :func:`rank_cdf`, self-loops dropped, vertex ids permuted."""
    dev = gen.device
    cdf = rank_cdf(n_vertices, alpha, dev)
    src = draw_ranks(cdf, n_edges, gen)
    dst = draw_ranks(cdf, n_edges, gen)
    keep = src != dst
    perm = torch.randperm(n_vertices, generator=gen, device=dev)
    return torch.stack([perm[src[keep]], perm[dst[keep]]], 1)


def _index_sets(part: torch.Tensor, ids: torch.Tensor, m: int,
                n_vertices: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per node the sorted unique ``ids`` of its edges, laid end to end
    (``uniq``, with ``counts`` [m]), and each edge's position in its
    node's set."""
    key = part * n_vertices + ids
    uk, inv = torch.unique(key, sorted=True, return_inverse=True)
    counts = torch.bincount(uk // n_vertices, minlength=m)
    first = torch.cumsum(counts, 0) - counts
    return uk % n_vertices, counts, inv - first[part]


def edge_partition(edges: torch.Tensor, n_vertices: int, m: int,
                   gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """Random edge partition over ``m`` nodes, edges grouped by node in
    their drawn order: ``src``, ``dst``, ``edge_counts`` [m], the in-sets
    (``in_idx`` end to end, ``in_counts``) and out-sets (``out_idx``,
    ``out_counts``), each edge's ``src_pos`` / ``dst_pos`` in its node's
    sets, and ``inv_outdeg`` (float64, 1 / out-degree of the source over
    the whole graph)."""
    part = torch.randint(0, m, (edges.shape[0],), generator=gen,
                         device=edges.device)
    order = torch.sort(part, stable=True).indices
    part = part[order]
    src, dst = edges[order, 0], edges[order, 1]
    in_idx, in_counts, src_pos = _index_sets(part, src, m, n_vertices)
    out_idx, out_counts, dst_pos = _index_sets(part, dst, m, n_vertices)
    outdeg = torch.bincount(src, minlength=n_vertices).clamp_(min=1)
    return {"src": src, "dst": dst,
            "edge_counts": torch.bincount(part, minlength=m),
            "in_idx": in_idx, "in_counts": in_counts, "src_pos": src_pos,
            "out_idx": out_idx, "out_counts": out_counts, "dst_pos": dst_pos,
            "inv_outdeg": 1.0 / outdeg[src].to(torch.float64)}


def hash_keys(gen: torch.Generator) -> Tuple[int, int]:
    """``(mult, xor)`` of an affine-xor bijection of [0, 2**32): an odd
    multiplier mixed with Knuth's, and a 31-bit xor."""
    draws = torch.randint(0, 1 << 31, (2,), generator=gen,
                          device=gen.device).tolist()
    mult = ((int(draws[0]) * 2 + 1) * _KNUTH) % (1 << 32)
    return mult | 1, int(draws[1])


def hash_ids(ids: torch.Tensor, mult: int, xor: int) -> torch.Tensor:
    """``((ids ^ xor) * mult) mod 2**32`` on int64, in two 16-bit halves
    of the multiplier so that no product leaves 63 bits."""
    x = (ids ^ xor) & 0xFFFFFFFF
    lo, hi = mult & 0xFFFF, mult >> 16
    return ((x * lo) + (((x * hi) & 0xFFFF) << 16)) & 0xFFFFFFFF


def hashed_layout(ranks: torch.Tensor, values: torch.Tensor, capacity: int,
                  mult: int, xor: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per node (row of ``ranks`` [m, D] feature ids, ``values`` [m, D]
    float32): hash the ids, coalesce equal ones by summing their values,
    sort, and lay them into ``capacity`` slots padded with SENTINEL and
    0: ``(idx int64 [m, capacity], val float32 [m, capacity])``.  Raises
    ``ValueError`` if a node's distinct ids exceed the capacity."""
    m = ranks.shape[0]
    dev = ranks.device
    h = hash_ids(ranks, mult, xor)
    node = torch.arange(m, device=dev)[:, None].expand_as(h)
    key = (node << 32) | h
    uk, inv = torch.unique(key.reshape(-1), sorted=True, return_inverse=True)
    sums = torch.zeros(uk.numel(), dtype=torch.float32, device=dev)
    sums.index_add_(0, inv, values.reshape(-1).to(torch.float32))
    unode = uk >> 32
    counts = torch.bincount(unode, minlength=m)
    most = int(counts.max())
    if most > capacity:
        raise ValueError(f"a node holds {most} distinct ids, over the "
                         f"capacity {capacity}")
    first = torch.cumsum(counts, 0) - counts
    pos = torch.arange(uk.numel(), device=dev) - first[unode]
    idx = torch.full((m, capacity), SENTINEL, dtype=torch.int64, device=dev)
    val = torch.zeros((m, capacity), dtype=torch.float32, device=dev)
    idx[unode, pos] = uk & 0xFFFFFFFF
    val[unode, pos] = sums
    return idx, val


def dyadic_values(shape, levels: int, scale_log2: int,
                  gen: torch.Generator) -> torch.Tensor:
    """float32 ``randint(-levels, levels + 1) * 2 ** scale_log2``: every
    partial sum of a union stays exact in float32 while the sums stay
    under ``2 ** (24 + scale_log2)``."""
    k = torch.randint(-levels, levels + 1, tuple(shape), generator=gen,
                      device=gen.device)
    return k.to(torch.float32) * math.ldexp(1.0, scale_log2)


def zipf_tokens(shape, vocab: int, alpha: float,
                gen: torch.Generator) -> torch.Tensor:
    """int64 Zipf(alpha) ids over ranks 1..vocab by inverse CDF, spread
    over the id space by a permutation."""
    dev = gen.device
    w = torch.arange(1, vocab + 1, dtype=torch.float64, device=dev) ** (-alpha)
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    ranks = draw_ranks(cdf, math.prod(shape), gen)
    perm = torch.randperm(vocab, generator=gen, device=dev)
    return perm[ranks].reshape(tuple(shape))
