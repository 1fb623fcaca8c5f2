"""Spectral methods: distributed power iteration (reference: ``repro.graph.spectral``).

Paper §I-A.2: "almost all eigenvalue algorithms use repeated
matrix-vector products" -- the product is the same edge-partitioned SpMV
plus Sparse Allreduce as PageRank's, and the Rayleigh normalisation is a
scalar sum per iteration.

``backend="sim"`` is the float64 numpy loop through the message-level
simulator (the oracle), with the scalar riding on a reserved index.
``backend="device"`` runs all iterations on one torch device through the
graph engine: the stacked-CSR SpMV kernel (``kernels.spmv_csr``), the
planned reduce, and the normalisation as an ownership-weighted whole-mesh
sum (``StackedTransport.psum``, the reference's ``lax.psum``), float32.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.api import SparseAllreduce
from .pagerank import build_partitions


def power_iteration(edges: np.ndarray, n_vertices: int, m: int,
                    degrees=(4, 2), iters: int = 30, symmetrize: bool = True,
                    backend: str = "sim", seed: int = 0, device=None
                    ) -> Tuple[float, np.ndarray, dict]:
    """Leading eigenvalue/eigenvector of the (symmetrized) adjacency matrix.

    Returns (eigenvalue, eigenvector [n], stats).

    ``backend="sim"``: per-iteration numpy loop, Rayleigh normalisation
    in float64 on the host.  ``backend="device"``: all ``iters``
    product + reduce + normalise rounds in one engine ``run`` on
    ``device`` (default: the current CUDA device, raising without one),
    float32; ``stats["engine"]`` carries the engine's report.
    """
    if symmetrize:
        edges = np.concatenate([edges, edges[:, ::-1]], axis=0)
    parts = build_partitions(edges, n_vertices, m, seed=seed)
    # adjacency matvec (unnormalized): weight 1 per edge
    for p in parts:
        p.inv_outdeg = np.ones_like(p.inv_outdeg)
    if backend == "device":
        return _power_iteration_device(parts, n_vertices, degrees, iters,
                                       seed, device)

    # one allreduce handles the matvec; the scalar rides along on a
    # reserved index (n_vertices) appended to every node's out/in sets
    scalar = np.uint32(n_vertices)
    ar = SparseAllreduce(m, degrees, backend=backend, seed=seed)
    ar.config([np.concatenate([p.out_idx, [scalar]]).astype(np.uint32)
               for p in parts],
              [np.concatenate([p.in_idx, [scalar]]).astype(np.uint32)
               for p in parts])

    rng = np.random.RandomState(seed)
    v = rng.randn(n_vertices)
    v /= np.linalg.norm(v)
    p_in = [v[p.in_idx] for p in parts]
    lam = 0.0
    for _ in range(iters):
        outs = [np.concatenate([p.spmv(p_in[i]), [0.0]])
                for i, p in enumerate(parts)]
        ins = ar.reduce(outs)
        # assemble the reduced vector once per vertex (first writer wins)
        q_full = np.zeros(n_vertices)
        seen = np.zeros(n_vertices, bool)
        for i, p in enumerate(parts):
            vals = ins[i][:-1]
            put = ~seen[p.in_idx]
            q_full[p.in_idx[put]] = vals[put]
            seen[p.in_idx] = True
        nrm = np.linalg.norm(q_full)
        if nrm == 0:
            break
        lam = nrm  # Rayleigh estimate for symmetric A with unit v
        v = q_full / nrm
        p_in = [v[p.in_idx] for p in parts]
    return float(lam), v, {"iters": iters}


def make_spectral_engine(parts, n_vertices: int, degrees, seed: int = 0,
                         device=None):
    """Build the device-resident power-iteration engine (config once, reuse
    per ``run``) over partitions whose weights are the adjacency's:
    returns ``(engine, extras, state0)`` -- the stacked CSR, the ownership
    weights ``norm_w`` (each vertex of the in-set union owned by the first
    node requesting it, so the squared-norm sum counts it once: the
    device analogue of the sim's first-writer-wins assembly) and the
    seeded unit start vector over each node's in-set.  Each round: out =
    the CSR SpMV of ``v``; the update normalises the reduced product by
    its norm, summed over the vertices each node owns and across the mesh
    with ``transport.psum``; a zero norm keeps the previous state."""
    import torch

    from . import engine as eng
    from .pagerank import LazyTables

    def update_fn(s, in_raw, e, tr):
        part = (e["norm_w"] * in_raw * in_raw).sum(1)
        nrm = torch.sqrt(tr.psum(part))
        ok = nrm > 0
        v2 = torch.where(ok.unsqueeze(1),
                         in_raw / torch.clamp(nrm, min=1e-30).unsqueeze(1),
                         s["v"])
        lam = torch.where(ok, nrm, s["lam"][:, 0]).unsqueeze(1)
        return {"v": v2, "lam": lam}

    app = eng.EngineApp(
        name="spectral", update_fn=update_fn,
        out_fn=lambda s, e: eng.csr_matvec(e["row_ptr"], e["cols"], e["wts"],
                                           s["v"], e["bins"]))
    m = len(parts)
    engine = eng.GraphEngine(
        [p.out_idx.astype(np.uint32) for p in parts],
        [p.in_idx.astype(np.uint32) for p in parts],
        app, degrees=degrees, device=device, seed=seed)
    row_ptr, cols, wts, bins = eng.stack_csr(
        LazyTables(parts), engine.u_cap, nnz=sum(len(p.src) for p in parts),
        device=engine.device, n_cols=engine.uin_cap)
    norm_w = np.zeros((m, engine.uin_cap), np.float32)
    seen = np.zeros(n_vertices, bool)
    for i, p in enumerate(parts):
        norm_w[i, : len(p.in_idx)] = ~seen[p.in_idx]
        seen[p.in_idx] = True
    rng = np.random.RandomState(seed)
    v = rng.randn(n_vertices)
    v /= np.linalg.norm(v)
    v0 = np.zeros((m, engine.uin_cap), np.float32)
    for i, p in enumerate(parts):
        v0[i, : len(p.in_idx)] = v[p.in_idx]
    extras = {"row_ptr": row_ptr, "cols": cols, "wts": wts, "bins": bins,
              "norm_w": norm_w}
    state0 = {"v": v0, "lam": np.zeros((m, 1), np.float32)}
    return (engine, eng.to_device(extras, engine.device),
            eng.to_device(state0, engine.device))


def _power_iteration_device(parts, n_vertices: int, degrees, iters: int,
                            seed: int, device
                            ) -> Tuple[float, np.ndarray, dict]:
    """Device path: product + reduce + normalisation per round, all
    ``iters`` rounds in one engine ``run``."""
    engine, extras, state0 = make_spectral_engine(parts, n_vertices, degrees,
                                                  seed, device)
    final, _, _ = engine.run(iters, state0, extras)
    v_dev = final["v"].cpu().numpy().astype(np.float64)
    lam = float(final["lam"][0, 0])

    v_full = np.zeros(n_vertices)
    seen = np.zeros(n_vertices, bool)
    for i, p in enumerate(parts):
        own = ~seen[p.in_idx]
        v_full[p.in_idx[own]] = v_dev[i, : len(p.in_idx)][own]
        seen[p.in_idx] = True
    return lam, v_full, {"iters": iters, "engine": engine.sync_report()}


def power_iteration_reference(edges: np.ndarray, n_vertices: int,
                              iters: int = 30, symmetrize: bool = True,
                              seed: int = 0) -> Tuple[float, np.ndarray]:
    """Float64 power iteration on the whole edge list (the oracle)."""
    if symmetrize:
        edges = np.concatenate([edges, edges[:, ::-1]], axis=0)
    rng = np.random.RandomState(seed)
    v = rng.randn(n_vertices)
    v /= np.linalg.norm(v)
    lam = 0.0
    for _ in range(iters):
        q = np.zeros(n_vertices)
        np.add.at(q, edges[:, 1], v[edges[:, 0]])
        lam = np.linalg.norm(q)
        if lam == 0:
            break
        v = q / lam
    return float(lam), v
