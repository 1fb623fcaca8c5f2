"""Public Sparse Allreduce API — the paper's two-call interface (reference: ``repro.core.api``).

    ar = SparseAllreduce(num_nodes=64, degrees=(16, 4), backend="device")
    ar.config(out_indices, in_indices)     # once per index pattern
    new_vals = ar.reduce(out_values)       # every iteration

Backends:
  * ``backend="sim"``    — the message-level numpy reference (+ timing
    model, replication, failures).  Default; runs anywhere.
  * ``backend="device"`` — host config + the planned reduce over the
    stacked mesh on one torch device: ``cuda`` unless the caller passes
    ``device="cpu"`` (which the tests do); without a CUDA device and
    without ``device=``, it raises.

``degrees="auto"`` resolves through ``topology.tune``.  Not ported yet,
each raising ``NotImplementedError`` with its ROADMAP item: the persistent
plan cache and ``retune`` (Queue 1 item 10), replication and ``dead`` on
the device backend (item 8), ``merge="banded"`` (item 7) and wire formats
other than ``"raw"`` (item 9).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from .allreduce import check_merge, make_device_plan, run_union_allreduce
from .netmodel import EC2_2013, Fabric
from .planned import PlannedSparseAllreduce, plan_sparse_allreduce
from .simulator import ReduceStats, SimSparseAllreduce
from .sparse_vec import HashPerm
from .topology import ButterflyPlan, check_wire, tune
from .transport import StackedTransport, as_index_tensor, resolve_device


class SparseAllreduce:
    """The paper's two-call primitive (module docstring): ``config`` once
    per index pattern, ``reduce`` every iteration, over the sim backend or
    the stacked-mesh device backend, plus the dynamic-index
    :meth:`union_reduce`."""

    def __init__(self, num_nodes: int, degrees="auto", *,
                 backend: str = "sim",
                 replication: int = 1, dead: Optional[Set[int]] = None,
                 fabric: Fabric = EC2_2013, seed: int = 0,
                 value_width: int = 1, device=None,
                 expected_nnz: float = 1e5, index_range: float = 1e6,
                 merge: str = "sort", wire: str = "raw",
                 plan_cache: bool = False, retune: bool = False):
        """``merge`` ("sort" | "fused") picks the per-layer merge of
        :meth:`union_reduce`; the planned :meth:`reduce` has no merge
        stage.  ``device`` binds the device backend (default: the current
        CUDA device, raising without one)."""
        check_merge(merge)
        if check_wire(wire) != "raw":
            raise NotImplementedError(
                f"wire={wire!r} is not ported yet (ROADMAP Queue 1 item 9)")
        if plan_cache or retune:
            raise NotImplementedError(
                "the persistent plan cache and retune are not ported yet "
                "(ROADMAP Queue 1 item 10)")
        if backend not in ("sim", "device"):
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "device" and (replication != 1 or dead):
            raise NotImplementedError(
                "replication / dead on the device backend is not ported yet "
                "(ROADMAP Queue 1 item 8)")
        self.merge = merge
        self.wire = wire
        self.num_nodes = num_nodes
        self.degrees_source = "explicit"
        if degrees == "auto":
            plan = tune(num_nodes, n0=expected_nnz, total_range=index_range,
                        fabric=fabric, wire=wire, value_width=value_width)
            degrees, self.degrees_source = plan.degrees, "tuned"
        self.plan = ButterflyPlan(num_nodes, tuple(degrees))
        self.backend = backend
        self.perm = HashPerm.make(seed)
        self.width = value_width
        self.fabric = fabric
        self.replication = replication
        self.dead = dead
        self.device = device
        self._sim: Optional[SimSparseAllreduce] = None
        self._planned: Optional[PlannedSparseAllreduce] = None
        self._reduce_fn = None
        self._union_cache = {}
        self.union_plan_stats = {"hits": 0, "misses": 0}
        self.config_cache = None

    @property
    def num_physical(self) -> int:
        """Physical node count: ``num_nodes`` logical shards × r."""
        return self.num_nodes * self.replication

    def _device(self) -> torch.device:
        return resolve_device(self.device)

    # ------------------------------------------------------------------
    def config(self, out_indices: Sequence[np.ndarray],
               in_indices: Sequence[np.ndarray]) -> ReduceStats:
        """The paper's ``config`` call — run once per index pattern.

        ``out_indices`` / ``in_indices``: one uint32 array per node (out
        need not be sorted or unique; in fixes the order of each node's
        result rows).  On ``sim`` it builds the message-level schedule; on
        ``device`` it freezes the routing (``plan_sparse_allreduce``) and
        binds the reduce to the device.  Returns the modeled
        ``ReduceStats`` of a simulator config on both backends.
        """
        self._in_lens = [len(i) for i in in_indices]
        self._out_lens = [len(o) for o in out_indices]
        sim = SimSparseAllreduce(
            self.plan, replication=self.replication, dead=self.dead,
            perm=self.perm, fabric=self.fabric, value_width=self.width)
        stats = sim.config(out_indices, in_indices)
        if self.backend == "sim":
            self._sim = sim
            return stats
        dplan = make_device_plan(
            [("nodes", self.num_nodes)], {"nodes": self.plan.degrees},
            in_capacity=max(self._out_lens),
            out_capacity=sum(self._out_lens))
        self._planned = plan_sparse_allreduce(
            dplan, out_indices, in_indices, perm=self.perm, width=self.width)
        self._reduce_fn = self._planned.make_reduce_fn(self._device())
        self.config_cache = "fresh"
        return stats

    # ------------------------------------------------------------------
    def reduce(self, out_values: Sequence[np.ndarray]) -> List[np.ndarray]:
        """``out_values``: one array per node, as declared at ``config``;
        returns each node's requested values (numpy)."""
        if self.backend == "sim":
            return self._sim.reduce(out_values)
        if self._reduce_fn is None:
            raise RuntimeError("call config() before reduce()")
        wshape = (self.width,) if self.width > 1 else ()
        staging = np.zeros((self.num_nodes, self._planned.u_cap) + wshape,
                           np.float32)
        for n, v in enumerate(out_values):
            if len(v) != self._out_lens[n]:
                raise ValueError(
                    f"reduce: node {n} passed {len(v)} values, config "
                    f"declared {self._out_lens[n]}")
            staging[n, : len(v)] = np.asarray(v, np.float32).reshape(
                (-1,) + wshape)
        out = self._reduce_fn(torch.from_numpy(staging)).cpu().numpy()
        return [out[n, : self._in_lens[n]] for n in range(self.num_nodes)]

    # ------------------------------------------------------------------
    def union_reduce(self, idx, val, out_capacity: int):
        """Gather-all union sum with dynamic indices (the paper's
        mini-batch mode) over the stacked mesh, honouring ``merge``.

        idx: [num_nodes, C] *hashed, sorted*, SENTINEL-padded indices
        (uint32 numpy or an integer tensor); val: [num_nodes, C] or
        [num_nodes, C, W].  Returns torch tensors on the bound device:
        (idx int64 [num_nodes, out_capacity], val, overflow [num_nodes]) —
        every node gets the full union sum.  The device plan and its
        transport are cached per (shape, out_capacity).  ``merge`` alone
        picks the plain (``"sort"``) or kernel (``"fused"``) merge; the
        reference's ``use_kernel`` argument is not taken.
        """
        dev = self._device()
        idx = as_index_tensor(idx, dev)
        val = torch.as_tensor(val, device=dev)
        if idx.shape[0] != self.num_nodes:
            raise ValueError(
                f"union_reduce: expected {self.num_nodes} chunks, got "
                f"{idx.shape[0]}")
        key = (tuple(idx.shape), out_capacity, str(dev))
        hit = self._union_cache.get(key)
        if hit is not None:
            self.union_plan_stats["hits"] += 1
        else:
            self.union_plan_stats["misses"] += 1
            dplan = make_device_plan(
                [("nodes", self.num_nodes)], {"nodes": self.plan.degrees},
                in_capacity=idx.shape[1], out_capacity=out_capacity)
            hit = self._union_cache[key] = (
                dplan, StackedTransport(dplan.logical, dev))
        dplan, transport = hit
        return run_union_allreduce(dplan, idx, val, merge=self.merge,
                                   transport=transport)

    # ------------------------------------------------------------------
    def planned_parts(self) -> Tuple[PlannedSparseAllreduce, torch.device]:
        """``(PlannedSparseAllreduce, device)`` bound at :meth:`config`
        (device backend only) — what an iterative caller such as
        ``repro_torch.graph.engine`` composes into its own loop."""
        if self.backend != "device":
            raise ValueError("planned_parts() requires backend='device'")
        if self._planned is None:
            raise RuntimeError("call config() before planned_parts()")
        return self._planned, self._device()

    @property
    def reduce_fn(self):
        """The bound reduce callable (device backend, after config):
        ``[num_nodes, u_cap(,W)] tensor -> [num_nodes, uin_cap(,W)]``."""
        if self._reduce_fn is None:
            raise RuntimeError(
                "reduce_fn requires backend='device' and a prior config()")
        return self._reduce_fn

    def staging_metadata(self) -> dict:
        """Static staging layout frozen by :meth:`config` (device backend):
        ``u_cap`` / ``uin_cap``, per-node ``out_lens`` / ``in_lens``,
        ``first_alive`` and ``num_physical``."""
        if self._planned is None:
            raise RuntimeError("call config() before staging_metadata()")
        return {
            "u_cap": self._planned.u_cap,
            "uin_cap": self._planned.uin_cap,
            "out_lens": list(self._out_lens),
            "in_lens": list(self._in_lens),
            "first_alive": list(range(self.num_nodes)),
            "num_physical": self.num_physical,
        }

    @property
    def stats(self) -> Optional[ReduceStats]:
        """Message-level :class:`ReduceStats` of the last :meth:`reduce`
        (sim backend only)."""
        if self.backend == "sim" and self._sim is not None:
            return getattr(self._sim, "reduce_stats", None)
        return None
