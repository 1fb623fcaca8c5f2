"""``python -m repro_torch.analysis --audit [--device cpu|cuda] [--json PATH]``.

The reference's self-contained audit sweep (``repro.analysis.cli``) on
the port's entry points: the planned reduce at degrees {(4,), (2, 2)} x
replication {1, 2}, a PageRank engine at (4, 2) plain and with
``overlap=True`` (5 rounds), and the bucketed hierarchical sync of three
leaves (64, 32 and 96 float32 elements a position, degrees (4, 2))
against its bucket-major twin; the port adds the greedy serving steps
of reduced qwen1.5-0.5b (prefill and decode at 2 data positions).  Exit
codes: 0 every audit clean, 1 a failed check, 2 a usage error.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Sequence

AUDIT_NODES = 8


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                description=__doc__.splitlines()[0])
    p.add_argument("--audit", action="store_true",
                   help="run the dispatch audit sweep")
    p.add_argument("--device", default=None,
                   help="device to audit on (default: the current CUDA "
                        "device)")
    p.add_argument("--json", metavar="PATH", default=None,
                   help="write the reports as JSON to PATH ('-' for "
                        "stdout)")
    return p


def configured(degs, r, device, seed=None):
    """A configured device ``SparseAllreduce`` of the sweep, on the
    reference's index sets (``prod(degs)`` nodes, 5-15 of 4,096 indices
    each, seeded with ``seed`` or the node count)."""
    import numpy as np
    from repro_torch.core.api import SparseAllreduce
    m = int(np.prod(degs))
    rng = np.random.RandomState(seed if seed is not None else m)
    out_idx = [rng.choice(4096, rng.randint(5, 16), replace=False)
               .astype(np.uint32) for _ in range(m)]
    in_idx = [rng.choice(4096, rng.randint(5, 16), replace=False)
              .astype(np.uint32) for _ in range(m)]
    ar = SparseAllreduce(m, degs, backend="device", replication=r,
                         device=device, seed=m, plan_cache=False)
    ar.config(out_idx, in_idx)
    return ar


def pagerank_engine(device, overlap: bool = False):
    """The sweep's PageRank engine (300 vertices, 1,200 edges, 8 nodes at
    degrees (4, 2)): ``(engine, extras, p0)``."""
    from repro_torch.data.pipeline import powerlaw_graph
    from repro_torch.graph.engine import GraphEngine
    from repro_torch.graph.pagerank import (build_partitions,
                                            make_pagerank_engine)
    edges = powerlaw_graph(300, 1200, seed=1)
    parts = build_partitions(edges, 300, AUDIT_NODES)
    engine, extras, p0 = make_pagerank_engine(parts, 300, degrees=(4, 2),
                                              device=device,
                                              plan_cache=False)
    if overlap:
        engine = GraphEngine(engine.out_sets, engine.in_sets, engine.app,
                             degrees=(4, 2), device=device, overlap=True,
                             plan_cache=False)
    return engine, extras, p0


def bucketed_sync_pair(device, sizes=(64, 32, 96)):
    """``(overlapped, sequential, args, depth)``: the bucketed stage-major
    hierarchical sync of leaves of ``sizes`` float32 elements a position
    (one bucket each) and its bucket-major twin, on 8 positions at
    degrees (4, 2)."""
    import torch
    from repro_torch.core.allreduce import (dense_allreduce_hierarchical,
                                            make_device_plan)
    from repro_torch.core.transport import StackedTransport
    from repro_torch.train.step import _bucketed_hier_leaves
    plan = make_device_plan([("d", AUDIT_NODES)], {"d": (4, 2)}, 8, 8)
    tr = StackedTransport(plan.logical, device)
    gen = torch.Generator().manual_seed(0)
    args = tuple(torch.randn((AUDIT_NODES, n), generator=gen).to(device)
                 for n in sizes)

    def overlapped(*xs):
        return _bucketed_hier_leaves(list(xs), plan, tr, bucket_bytes=1)

    def sequential(*xs):
        return [dense_allreduce_hierarchical(x, plan, tr) for x in xs]
    return overlapped, sequential, args, plan.logical.depth


def serve_steps(device):
    """Reduced qwen1.5-0.5b's greedy prefill and decode steps, and the
    raw decode step, at 2 data positions, with their inputs:
    ``(cfg, params, prefill_greedy, decode_greedy, decode, batch, token,
    pos, cache)``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.train import step as S
    cfg = get_config("qwen1.5-0.5b").reduced()
    mc = S.mesh_ctx(2, device=device)
    params = T.init_params(cfg, 1, seed=0, device=device)
    toks = np.random.RandomState(0).randint(0, cfg.vocab, (2, 8))
    batch = {"tokens": torch.as_tensor(toks, device=device)}
    pf, _ = S.make_prefill_greedy_step(cfg, mc, 16)
    dg, _ = S.make_decode_greedy_step(cfg, mc)
    dr, _ = S.make_decode_step(cfg, mc)
    ids, cache = pf(params, batch)
    pos = torch.full((2,), 8, dtype=torch.int64, device=device)
    return cfg, params, pf, dg, dr, batch, ids, pos, cache


def audit_sweep(device=None) -> List:
    """The sweep's reports, on ``device`` (default: the current CUDA
    device)."""
    from repro_torch.core.transport import resolve_device
    from .auditor import (audit_engine, audit_overlap_sync, audit_reduce,
                          audit_serve_decode)
    device = resolve_device(device)
    reports = []
    for degs in [(4,), (2, 2)]:
        for r in (1, 2):
            reports.append(audit_reduce(configured(degs, r, device)))
    for overlap in (False, True):
        engine, extras, p0 = pagerank_engine(device, overlap)
        reports.append(audit_engine(engine, 5, p0, extras))
    ov, sq, args, depth = bucketed_sync_pair(device)
    reports.append(audit_overlap_sync("_bucketed_hier_leaves", ov, sq, *args,
                                      depth=depth, n_buckets=len(args)))
    cfg, params, pf, dg, _, batch, ids, pos, cache = serve_steps(device)
    reports.append(audit_serve_decode("make_prefill_greedy_step", pf,
                                      params, batch, vocab=cfg.vocab))
    reports.append(audit_serve_decode("make_decode_greedy_step", dg, params,
                                      ids, pos, cache, vocab=cfg.vocab))
    return reports


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Entry point; returns the process exit code."""
    try:
        args = _build_parser().parse_args(argv)
    except SystemExit as e:
        return 2 if e.code else 0
    if not args.audit:
        print("nothing to do: pass --audit", file=sys.stderr)
        return 2
    reports = audit_sweep(args.device)
    for a in reports:
        print(f"audit [{'ok' if a.ok else 'FAIL'}] {a.target}")
        for c in a.failures():
            print(f"    {c}")
    if args.json:
        text = json.dumps([a.to_dict() for a in reports], indent=1,
                          default=str)
        if args.json == "-":
            print(text)
        else:
            with open(args.json, "w") as f:
                f.write(text)
    ok = all(a.ok for a in reports)
    print(f"{len(reports)} audit(s) -> {'clean' if ok else 'FAIL'}")
    return 0 if ok else 1
