"""HADI diameter estimation over Sparse Allreduce (reference: ``repro.graph.hadi``).

Paper §I-A.2, eq. 3: HADI iterates ``b^{h+1} = G x_or b^h`` over
Flajolet-Martin bitstrings.  The allreduce is additive, and OR transfers
exactly because the bitstrings are 0/1 vectors: ``OR(a, b) = min(a + b,
1)`` -- sum through the network, clamp at the receiver.  Neighbourhood
size per FM: ``N(h) ~ 2^{b(h)} / 0.77351`` with b the mean lowest zero
bit; the effective diameter is the smallest h with ``N(h) >= 0.9 *
N(h_max)``.

``backend="sim"`` is the float64 numpy loop through the message-level
simulator (the oracle).  ``backend="device"`` runs all hops on one torch
device through the graph engine: the width-W product on the stacked CSR
(``engine.csr_matvec_wide``, W = trials * bits) and the planned reduce,
float32, whose 0/1 sums are exact, so the bitstrings equal the sim's bit
for bit.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.api import SparseAllreduce
from .pagerank import build_partitions

FM_PHI = 0.77351


def fm_bitstrings(n: int, bits: int, trials: int, rng) -> np.ndarray:
    """[n, trials, bits] 0/1 -- bit i set with prob 2^-(i+1)."""
    probs = 2.0 ** (-(np.arange(bits) + 1.0))
    return (rng.random_sample((n, trials, bits)) < probs).astype(np.float64)


def _fm_estimate(b: np.ndarray) -> float:
    """b: [n, trials, bits] union bitstrings -> neighbourhood size sum."""
    zero = b < 0.5
    low = np.argmax(zero, axis=-1)          # lowest zero bit per (v, trial)
    low = np.where(zero.any(axis=-1), low, b.shape[-1])
    return float(np.sum(2.0 ** np.mean(low, axis=-1) / FM_PHI))


def _effective_diameter(curve) -> Tuple[int, np.ndarray]:
    curve = np.array(curve)
    return int(np.argmax(curve >= 0.9 * curve[-1])), curve


def hadi(edges: np.ndarray, n_vertices: int, m: int, degrees=(4, 2),
         max_hops: int = 16, bits: int = 24, trials: int = 4,
         backend: str = "sim", seed: int = 0, device=None
         ) -> Tuple[int, np.ndarray, dict]:
    """Returns (effective diameter, N(h) curve, stats).

    ``backend="sim"``: per-hop numpy loop through the simulator.
    ``backend="device"``: all ``max_hops`` OR-rounds in one engine
    ``run`` on ``device`` (default: the current CUDA device, raising
    without one), every hop's state collected; the host folds the hops
    one at a time and applies the sim loop's plateau early stop.
    ``stats["engine"]`` carries the engine's report.
    """
    rng = np.random.RandomState(seed)
    parts = build_partitions(edges, n_vertices, m, seed=seed)
    # inbound = read-set for the next hop PLUS own written rows, so every
    # vertex with in-edges receives its updated bitstring somewhere
    req = [np.union1d(p.in_idx, p.out_idx).astype(np.uint32) for p in parts]
    if backend == "device":
        return _hadi_device(parts, req, n_vertices, degrees, max_hops,
                            bits, trials, rng, seed, device)
    ar = SparseAllreduce(m, degrees, backend=backend, seed=seed,
                         value_width=trials * bits)
    ar.config([p.out_idx.astype(np.uint32) for p in parts], req)

    b = fm_bitstrings(n_vertices, bits, trials, rng)  # global (self-bit)
    b0 = b.copy()
    curve = [_fm_estimate(b)]
    for _ in range(max_hops):
        # out value of a row v = OR over partition edges of b[src]
        outs = []
        for p in parts:
            acc = np.zeros((len(p.out_idx), trials, bits))
            np.add.at(acc, p.dst_pos, b[p.src])
            outs.append(np.minimum(acc, 1.0).reshape(len(p.out_idx), -1))
        ins = ar.reduce(outs)
        newb = b.copy()
        for i, p in enumerate(parts):
            ridx = np.union1d(p.in_idx, p.out_idx)
            got = np.minimum(ins[i], 1.0).reshape(-1, trials, bits)
            newb[ridx] = np.maximum(newb[ridx], got)
        # vertices also OR their own previous bits (self-loop in HADI)
        b = np.maximum(b, newb)
        est = _fm_estimate(b)
        curve.append(est)
        if est <= curve[-2] * 1.0001:
            break
    eff, curve = _effective_diameter(curve)
    return eff, curve, {"hops_run": len(curve) - 1, "b0": b0, "b_final": b}


def make_hadi_engine(parts, req, degrees, bits: int, trials: int,
                     b0: np.ndarray, seed: int = 0, device=None):
    """Build the device-resident HADI engine (config once, reuse per
    ``run``): returns ``(engine, extras, state0)`` -- the stacked CSR of
    the OR product (edge (src, dst) adds b[src] to row dst: cols = src's
    position in the node's request set ``req[i]``, rows = dst's position
    in its out set, weight 1) and the initial bitstrings ``b0`` [n,
    trials, bits] over each node's request set, ``[M, uin_cap, W]``.
    Each round: out = min(W-wide CSR product, 1), state = max(state,
    min(in, 1))."""
    import torch

    from . import engine as eng
    m, w = len(parts), trials * bits
    app = eng.EngineApp(
        name="hadi", value_width=w,
        out_fn=lambda s, e: torch.clamp(eng.csr_matvec_wide(
            e["row_ptr"], e["cols"], e["wts"], s), max=1.0),
        update_fn=lambda s, in_raw, e, tr:
            torch.maximum(s, torch.clamp(in_raw, max=1.0)))
    engine = eng.GraphEngine(
        [p.out_idx.astype(np.uint32) for p in parts], req, app,
        degrees=degrees, device=device, seed=seed)
    tables = [eng.build_csr(p.dst_pos, np.searchsorted(req[i], p.src),
                            np.ones(len(p.src), np.float32), len(p.out_idx))
              for i, p in enumerate(parts)]
    row_ptr, cols, wts, _ = eng.stack_csr(tables, engine.u_cap,
                                          device=engine.device,
                                          n_cols=engine.uin_cap)
    del tables
    state0 = np.zeros((m, engine.uin_cap, w), np.float32)
    for i, r in enumerate(req):
        state0[i, : len(r)] = b0[r].reshape(len(r), w)
    return (engine, {"row_ptr": row_ptr, "cols": cols, "wts": wts},
            eng.to_device(state0, engine.device))


def _hadi_device(parts, req, n_vertices: int, degrees, max_hops: int,
                 bits: int, trials: int, rng, seed: int, device
                 ) -> Tuple[int, np.ndarray, dict]:
    """Device path: all hops in one ``run``, early stop applied after.

    Per-node state = bitstrings over the node's request set.  Where the
    reference turns the whole trajectory into float64 on the host, the
    hops are read back and folded one at a time (one hop's state on the
    host at once), with the same result."""
    b0 = fm_bitstrings(n_vertices, bits, trials, rng)
    engine, extras, state0 = make_hadi_engine(parts, req, degrees, bits,
                                              trials, b0, seed, device)
    _, _, traj = engine.run(max_hops, state0, extras, collect="trajectory")
    del state0, extras

    b = b0.copy()
    curve = [_fm_estimate(b)]
    for h in range(max_hops):
        hop = traj[h].cpu().numpy()               # [M, req_cap, w] f32
        for i, r in enumerate(req):
            b[r] = np.maximum(b[r], hop[i, : len(r)].reshape(len(r), trials,
                                                             bits))
        est = _fm_estimate(b)
        curve.append(est)
        if est <= curve[-2] * 1.0001:
            break
    eff, curve = _effective_diameter(curve)
    return eff, curve, {"hops_run": len(curve) - 1, "b0": b0, "b_final": b,
                        "engine": engine.sync_report()}


def hadi_bitstring_reference(edges: np.ndarray, n_vertices: int,
                             b0: np.ndarray, hops: int) -> np.ndarray:
    """Deterministic oracle: global OR-iteration of the same bitstrings.
    Distributed HADI must produce bit-identical strings after each hop."""
    b = b0.copy()
    for _ in range(hops):
        new = b.copy()
        acc = np.zeros_like(b)
        np.add.at(acc, edges[:, 1], b[edges[:, 0]])
        new = np.maximum(new, np.minimum(acc, 1.0))
        b = np.maximum(b, new)
    return b


def bfs_neighbourhood_reference(edges: np.ndarray, n_vertices: int,
                                max_hops: int) -> np.ndarray:
    """Exact N(h) = total pairs within h hops (small graphs; oracle)."""
    radj = [[] for _ in range(n_vertices)]   # in-neighbours: b[d] |= b[s]
    for s, d in edges:
        radj[d].append(s)
    curve = [n_vertices]
    reach = [1 << v for v in range(n_vertices)]  # bitset per vertex
    for _ in range(max_hops):
        new = list(reach)
        for v in range(n_vertices):
            acc = reach[v]
            for u in radj[v]:
                acc |= reach[u]
            new[v] = acc
        reach = new
        curve.append(sum(bin(r).count("1") for r in reach))
        if curve[-1] == curve[-2]:
            break
    return np.array(curve, np.float64)
