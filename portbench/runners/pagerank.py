"""PageRank jobs on the port's graph engine.

Set-up draws the configuration's power-law graph (``vertices``,
``edges``, ``alpha``) on the device from the seed
(``generate.powerlaw_edges``), partitions its edges at random over the
configuration's nodes, hands the partitions to the program as its
``Partition`` records, and builds the engine with
``make_pagerank_engine`` (the host ``config`` once, the stacked CSR, the
uniform start vector).  A unit is one job: ``rounds`` rounds from the
uniform vector by one ``GraphEngine.run`` (on the card one CUDA graph
replay), then a synchronisation, as a job that reads its scores waits.

The check: the final partial products of a sample of jobs, drawn from
the seed by reservoir sampling over the window, assembled into global
scores, against the plain float64 PageRank of the same edge list
(``reference/pagerank.py``), by the largest relative error over the
vertices.
"""
from __future__ import annotations

import random
import sys
import time

import numpy as np
import torch

from portbench import generate, roofline
from portbench.reference import pagerank as ref


class Cell:
    unit = "job"

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 log=sys.stderr):
        from repro_torch.graph.pagerank import Partition, make_pagerank_engine
        self.device = torch.device(device)
        self.n = int(config["vertices"])
        self.m = int(config["nodes"])
        self.k = int(traffic["rounds"])
        self.damping = float(traffic["damping"])
        self.limits = traffic["limits"]
        self.work = {"rounds": self.k}
        t0 = time.perf_counter()
        gen = generate.generator(seed, self.device, stream=1)
        edges = generate.powerlaw_edges(self.n, int(config["edges"]),
                                        float(config["alpha"]), gen)
        self.graph = generate.edge_partition(edges, self.n, self.m, gen)
        del edges
        g = {k: v.cpu().numpy() for k, v in self.graph.items()}
        t1 = time.perf_counter()
        parts = []
        cuts = {k: np.cumsum(g[k])[:-1] for k in
                ("edge_counts", "in_counts", "out_counts")}
        split = lambda key, by: np.split(g[key], cuts[by])  # noqa: E731
        for src, dst, inn, out, sp, dp, w in zip(
                split("src", "edge_counts"), split("dst", "edge_counts"),
                split("in_idx", "in_counts"), split("out_idx", "out_counts"),
                split("src_pos", "edge_counts"),
                split("dst_pos", "edge_counts"),
                split("inv_outdeg", "edge_counts")):
            parts.append(Partition(src=src, dst=dst, in_idx=inn, out_idx=out,
                                   src_pos=sp, dst_pos=dp, inv_outdeg=w))
        self.engine, self.extras, self.p0 = make_pagerank_engine(
            parts, self.n, degrees=tuple(config["degrees"]),
            damping=self.damping, seed=int(config["plan_seed"]),
            device=self.device, plan_cache=False)
        t2 = time.perf_counter()
        print(f"pagerank set-up: graph {t1 - t0:.3f} s, engine {t2 - t1:.3f} s, "
              f"edges {int(self.graph['src'].numel())}", file=log)
        self.rng = random.Random(int(seed))
        self.keep = int(traffic["sample_jobs"])
        self.sample = []

    def warm(self) -> None:
        """The capture (its warm-up round and the graph), then one replay."""
        for _ in range(2):
            self.engine.run(self.k, self.p0, self.extras)

    def step(self, i: int) -> None:
        _, last_q, _ = self.engine.run(self.k, self.p0, self.extras)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        if len(self.sample) < self.keep:
            self.sample.append(last_q)
        else:
            j = self.rng.randrange(i + 1)
            if j < self.keep:
                self.sample[j] = last_q

    def facts(self) -> dict:
        nnz = int(self.graph["src"].numel())
        rows = int(self.graph["out_counts"].sum())
        state = int(self.graph["in_counts"].sum())
        return {"round_bytes": roofline.pagerank_round_bytes(nnz, rows, state),
                "spmv_bytes": roofline.csr_product_bytes(nnz, rows, state,
                                                         rows)}

    def check(self) -> dict:
        """Free the engine, then hold each sampled job's scores to the
        float64 reference."""
        del self.engine, self.extras, self.p0
        g = self.graph
        want = ref.pagerank(g["src"], g["dst"], g["inv_outdeg"], self.n,
                            self.k, self.damping)
        node = torch.repeat_interleave(
            torch.arange(self.m, device=self.device), g["out_counts"])
        first = torch.cumsum(g["out_counts"], 0) - g["out_counts"]
        col = torch.arange(node.numel(), device=self.device) - first[node]
        worst, bad = 0.0, 0
        for last_q in self.sample:
            got = ref.assemble(g["out_idx"], last_q[node, col], self.n,
                               self.damping)
            err = ref.max_rel_err(got, want)
            bad += err > self.limits["rel_err"]
            worst = max(worst, err)
        return {"checks": [{"name": "rel_err", "value": worst,
                            "limit": self.limits["rel_err"],
                            "ok": bool(self.sample)
                            and worst <= self.limits["rel_err"]}],
                "failed": int(bad)}

    def control(self, dtype=torch.bfloat16) -> dict:
        """The compared number with the reference in ``dtype`` put in the
        program's place."""
        g = self.graph
        args = (g["src"], g["dst"], g["inv_outdeg"], self.n, self.k,
                self.damping)
        want = ref.pagerank(*args)
        return {"rel_err": ref.max_rel_err(ref.pagerank(*args, dtype=dtype),
                                           want)}
