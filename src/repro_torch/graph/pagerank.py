"""Distributed PageRank on Sparse Allreduce (reference: ``repro.graph.pagerank``).

Paper §I-A.2, §III-B, Fig 9: random edge partition across M nodes; each
node's outbound set = rows its edges write, inbound set = columns its
edges read; ``config`` once (static graph), then per iteration
``in.values = reduce(out.values)`` + local SpMV.

``backend="sim"`` is the float64 numpy loop through the message-level
simulator (the oracle).  ``backend="device"`` runs all rounds on one torch
device through the graph engine: the ELL SpMV CUDA kernel and the planned
reduce over the stacked mesh, float32.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.api import SparseAllreduce
from repro_torch.core.netmodel import EC2_2013, Fabric
from repro_torch.data.pipeline import random_edge_partition


@dataclasses.dataclass
class Partition:
    """One node's share of the edge-partitioned graph."""
    src: np.ndarray           # [E_i] global column ids (reads)
    dst: np.ndarray           # [E_i] global row ids (writes)
    in_idx: np.ndarray        # unique sorted src
    out_idx: np.ndarray       # unique sorted dst
    src_pos: np.ndarray       # src -> position in in_idx
    dst_pos: np.ndarray       # dst -> position in out_idx
    inv_outdeg: np.ndarray    # [E_i] 1/outdeg of src (column-normalized G)

    def spmv(self, in_values: np.ndarray) -> np.ndarray:
        """out[dst_pos] += in[src_pos] / outdeg(src) (float64 numpy)."""
        out = np.zeros(len(self.out_idx), np.float64)
        np.add.at(out, self.dst_pos, in_values[self.src_pos] * self.inv_outdeg)
        return out

    def ell_tables(self, weights: Optional[np.ndarray] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Padded ELL ``(cols, wts)`` of this partition's SpMV
        (``engine.build_ell``), the layout the device engine stacks."""
        from .engine import build_ell
        w = self.inv_outdeg if weights is None else weights
        return build_ell(self.dst_pos, self.src_pos, w, len(self.out_idx))

    def ell_width(self) -> int:
        """K of :meth:`ell_tables` (the largest row count), without
        building the tables."""
        return max(int(np.bincount(self.dst_pos).max(initial=0)), 1)


def build_partitions(edges: np.ndarray, n_vertices: int, m: int,
                     seed: int = 0) -> List[Partition]:
    """Random edge partition of ``edges`` over ``m`` nodes, with each
    node's index sets and local positions."""
    outdeg = np.bincount(edges[:, 0], minlength=n_vertices).astype(np.float64)
    outdeg[outdeg == 0] = 1.0
    parts = []
    for e in random_edge_partition(edges, m, seed=seed):
        src, dst = e[:, 0], e[:, 1]
        in_idx = np.unique(src)
        out_idx = np.unique(dst)
        parts.append(Partition(
            src=src, dst=dst, in_idx=in_idx, out_idx=out_idx,
            src_pos=np.searchsorted(in_idx, src),
            dst_pos=np.searchsorted(out_idx, dst),
            inv_outdeg=1.0 / outdeg[src]))
    return parts


def pagerank(edges: np.ndarray, n_vertices: int, m: int,
             degrees=(4, 2), iters: int = 10, damping: float = 0.85,
             backend: str = "sim", fabric: Fabric = EC2_2013,
             use_kernel: bool = False, seed: int = 0, device=None
             ) -> Tuple[np.ndarray, dict]:
    """Returns (scores [n_vertices], stats).  Unreached vertices keep the
    teleport mass only.

    ``backend="sim"``: per-iteration float64 numpy loop through the
    simulator.  ``backend="device"``: all ``iters`` rounds on ``device``
    (default: the current CUDA device, raising without one) through the
    graph engine, float32; ``stats["engine"]`` carries its report.
    ``use_kernel`` is kept for signature parity: the device path always
    runs the ELL kernel, the sim path always the numpy product.
    """
    parts = build_partitions(edges, n_vertices, m, seed=seed)
    if backend == "device":
        return _pagerank_device(parts, n_vertices, degrees, iters, damping,
                                seed, fabric, device)
    ar = SparseAllreduce(m, degrees, backend=backend, fabric=fabric,
                         seed=seed)
    cstats = ar.config([p.out_idx.astype(np.uint32) for p in parts],
                       [p.in_idx.astype(np.uint32) for p in parts])
    # node i holds P over its in_idx; outbound values are the partial
    # products q_i (no teleport: the receiver applies P = (1-d)/n + d*sum(q)
    # after the reduce, so teleport counts once).
    p_in = [np.full(len(p.in_idx), 1.0 / n_vertices) for p in parts]
    q_partial = [np.zeros(len(p.out_idx)) for p in parts]
    reduce_time = 0.0
    for _ in range(iters):
        for i, p in enumerate(parts):
            q_partial[i] = p.spmv(p_in[i])
        in_raw = ar.reduce(q_partial)
        if ar.stats is not None:
            reduce_time += ar.stats.reduce_time_s
        for i in range(m):
            p_in[i] = (1 - damping) / n_vertices + damping * in_raw[i]
    qsum = np.zeros(n_vertices)
    for i, p in enumerate(parts):
        np.add.at(qsum, p.out_idx, q_partial[i])
    scores = (1 - damping) / n_vertices + damping * qsum
    return scores, {"config": cstats, "reduce_time_s": reduce_time}


def make_pagerank_app(parts: List[Partition], n_vertices: int,
                      damping: float = 0.85, use_kernel: bool = False):
    """The engine-agnostic PageRank pieces: ``(app, out_sets, in_sets)``.
    ``use_kernel`` is kept for signature parity: the app's product always
    runs the ELL kernel (its plain version for CPU tensors)."""
    from . import engine as eng
    app = eng.EngineApp(
        name="pagerank",
        out_fn=lambda s, e: eng.ell_matvec(e["cols"], e["wts"], s),
        update_fn=lambda s, in_raw, e, tr:
            (1.0 - damping) / n_vertices + damping * in_raw)
    return (app,
            [p.out_idx.astype(np.uint32) for p in parts],
            [p.in_idx.astype(np.uint32) for p in parts])


class _LazyEllTables:
    """``tables[i]`` builds partition i's ELL tables on access, so
    ``stack_ell`` holds one node's tables at a time on the host."""

    def __init__(self, parts: List[Partition]):
        self.parts = parts

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i].ell_tables()


def pagerank_state(parts: List[Partition], n_vertices: int,
                   u_cap: int, uin_cap: int, device=None):
    """Stacked ELL extras + the uniform initial state for a PageRank run
    over ``parts``, sized to an engine's frozen ``u_cap`` / ``uin_cap``,
    built straight on ``device`` (default: the current CUDA device): the
    ``[M, u_cap, K]`` tables are preallocated there and filled one node
    at a time."""
    import torch

    from . import engine as eng
    from repro_torch.core.transport import resolve_device
    device = resolve_device(device)
    kmax = max(p.ell_width() for p in parts)
    cols, wts = eng.stack_ell(_LazyEllTables(parts), u_cap, kmax=kmax,
                              device=device, n_cols=uin_cap)
    p0 = np.zeros((len(parts), uin_cap), np.float32)
    for i, p in enumerate(parts):
        p0[i, : len(p.in_idx)] = 1.0 / n_vertices
    return {"cols": cols, "wts": wts}, torch.as_tensor(p0, device=device)


def make_pagerank_engine(parts: List[Partition], n_vertices: int,
                         degrees=(4, 2), damping: float = 0.85,
                         use_kernel: bool = False, seed: int = 0,
                         fabric: Fabric = EC2_2013, device=None):
    """Build the device-resident PageRank engine (config once, reuse per
    ``run``): returns ``(engine, extras, p0)`` — everything
    ``engine.run(k, p0, extras)`` needs.  ``use_kernel`` is kept for
    signature parity, as in :func:`make_pagerank_app`."""
    from . import engine as eng
    app, out_sets, in_sets = make_pagerank_app(parts, n_vertices, damping)
    engine = eng.GraphEngine(out_sets, in_sets, app, degrees=degrees,
                             device=device, seed=seed, fabric=fabric)
    extras, p0 = pagerank_state(parts, n_vertices, engine.u_cap,
                                engine.uin_cap, device=engine.device)
    return engine, extras, p0


def assemble_pagerank_scores(parts: List[Partition], last_q, n_vertices: int,
                             damping: float) -> np.ndarray:
    """Global scores from the engine's final partial products ``last_q``
    ``[M, u_cap]`` (tensor or array; teleport added once)."""
    if hasattr(last_q, "cpu"):
        last_q = last_q.cpu().numpy()
    last_q = np.asarray(last_q, np.float64)
    qsum = np.zeros(n_vertices)
    for i, p in enumerate(parts):
        np.add.at(qsum, p.out_idx, last_q[i, : len(p.out_idx)])
    return (1 - damping) / n_vertices + damping * qsum


def _pagerank_device(parts: List[Partition], n_vertices: int, degrees,
                     iters: int, damping: float, seed: int, fabric: Fabric,
                     device) -> Tuple[np.ndarray, dict]:
    """Device path: ``iters`` rounds through the graph engine."""
    engine, extras, p0 = make_pagerank_engine(
        parts, n_vertices, degrees, damping, seed=seed, fabric=fabric,
        device=device)
    _, last_q, _ = engine.run(iters, p0, extras)
    scores = assemble_pagerank_scores(parts, last_q, n_vertices, damping)
    stats = {"config": engine.config_stats, "reduce_time_s": 0.0,
             "engine": engine.sync_report()}
    return scores, stats


def pagerank_dense_reference(edges: np.ndarray, n_vertices: int,
                             iters: int = 10, damping: float = 0.85
                             ) -> np.ndarray:
    """Dense float64 PageRank over the whole edge list (the oracle)."""
    outdeg = np.bincount(edges[:, 0], minlength=n_vertices).astype(np.float64)
    outdeg[outdeg == 0] = 1.0
    p = np.full(n_vertices, 1.0 / n_vertices)
    for _ in range(iters):
        q = np.zeros(n_vertices)
        np.add.at(q, edges[:, 1], p[edges[:, 0]] / outdeg[edges[:, 0]])
        p = (1 - damping) / n_vertices + damping * q
    return p
