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

``merge`` ("sort" | "fused" | "banded") and ``wire`` ("raw" | "delta" |
"delta+bf16" | "delta+int8ef") shape :meth:`SparseAllreduce.union_reduce`;
the lossy wires have no meaning on the sim backend or the planned
``reduce`` and are refused there, as in the reference.

Both backends take ``replication=r`` and ``dead`` (paper §V):
``num_nodes`` logical shards are hosted r-way, on the device backend over
``r * num_nodes`` stacked physical nodes laid out per
``core.replication.replica_groups``; the reduce gives unchanged results
for any dead set that leaves each replica group an alive member, and
raises ``DeadLogicalNode`` otherwise.  :meth:`SparseAllreduce.
reconfig_dead` swaps the dead set of a configured instance without
replanning.

``degrees="auto"`` resolves through the autotuner
(:mod:`repro_torch.core.autotune`): the persistent plan cache
(``$REPRO_PLAN_CACHE`` or ``~/.cache/repro/plans``) is read before the
cost-model sweep runs.  On the device backend :meth:`SparseAllreduce.
config` is served from three tiers, reported in ``config_cache``: the
in-process memo (``"memo"``: the same frozen plan object and reduce
callable), the plan cache on disk (``"disk"``: the frozen routing arrays,
moved to the device once), else a host replan (``"fresh"``), which is
then stored in both.  ``nodes=`` names the pool positions that host the
stacked physical nodes (default ``range(num_physical)``); with the
device, it is part of the memo and disk keys, as the reference's mesh
device ids are.  On one card the positions change no computation: the
stacked reduce is the same whichever positions are named.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels.wirecodec import LOSSY_WIRE

from . import autotune
from .allreduce import check_merge, make_device_plan, run_union_allreduce
from .netmodel import EC2_2013, Fabric
from .planned import PlannedSparseAllreduce, plan_sparse_allreduce
from .replication import first_alive_replicas
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
                 plan_cache=True, retune: bool = False,
                 nodes: Optional[Sequence[int]] = None):
        """``merge`` ("sort" | "fused" | "banded") picks the per-layer
        merge of :meth:`union_reduce` and ``wire`` its exchanged payload
        (``repro_torch.kernels.wirecodec``); the planned :meth:`reduce`
        has neither.  ``device`` binds the device backend (default: the
        current CUDA device, raising without one).

        ``plan_cache``: ``True`` (default) uses the process cache at
        ``$REPRO_PLAN_CACHE`` / ``~/.cache/repro/plans``, a ``PlanCache``
        pins a root, ``False`` turns the disk tier off (``degrees="auto"``
        still tunes, ``config`` still memoizes in-process).
        ``retune=True`` bypasses cached degree reads and overwrites them.
        ``nodes``: the pool positions of the ``num_physical`` stacked
        nodes (module docstring)."""
        check_merge(merge)
        check_wire(wire)
        if backend == "sim" and wire in LOSSY_WIRE:
            raise NotImplementedError(
                f"backend='sim' models message bytes, not value precision; "
                f"wire={wire!r} has no sim semantics (use 'raw' or "
                f"'delta', or backend='device')")
        if backend not in ("sim", "device"):
            raise ValueError(f"unknown backend {backend!r}")
        if plan_cache is True:
            self.plan_cache = autotune.default_cache()
        elif plan_cache is False or plan_cache is None:
            self.plan_cache = None
        elif isinstance(plan_cache, autotune.PlanCache):
            self.plan_cache = plan_cache
        else:
            raise ValueError(
                f"plan_cache must be True, False or a PlanCache (to pin a "
                f"root, pass PlanCache(root=...)), got {plan_cache!r}")
        self.merge = merge
        self.wire = wire
        self.num_nodes = num_nodes
        self.degrees_source = "explicit"
        if degrees == "auto":
            if self.plan_cache is not None:
                degrees, self.degrees_source = autotune.resolve_degrees(
                    num_nodes, n0=expected_nnz, total_range=index_range,
                    fabric=fabric, merge=merge, replication=replication,
                    width=value_width, cache=self.plan_cache, retune=retune,
                    wire=wire)
            else:
                plan = tune(num_nodes, n0=expected_nnz,
                            total_range=index_range, fabric=fabric,
                            wire=wire, value_width=value_width)
                degrees, self.degrees_source = plan.degrees, "tuned"
        self.plan = ButterflyPlan(num_nodes, tuple(degrees))
        m_phys = num_nodes * replication
        self.nodes = tuple(range(m_phys)) if nodes is None else tuple(
            int(p) for p in nodes)
        if len(self.nodes) != m_phys or len(set(self.nodes)) != m_phys:
            raise ValueError(f"nodes must name {m_phys} distinct pool "
                             f"positions, got {self.nodes}")
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
        self._first_alive = None
        self._repair_cache = {}
        # how the last config() / reconfig_dead() was satisfied on the
        # device backend: None | "fresh" | "memo" | "disk" | "repair" (a
        # dead-set swap)
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

        ``out_indices`` / ``in_indices``: one uint32 array per *logical*
        node (out need not be sorted or unique; in fixes the order of each
        node's result rows).  On ``sim`` it builds the message-level
        schedule; on ``device`` it freezes the routing of all physical
        replicas (``plan_sparse_allreduce``) and binds the reduce to the
        device, served from the memo, the disk cache or a fresh replan
        (module docstring; ``config_cache`` says which).  Raises
        ``DeadLogicalNode`` when ``dead`` kills a whole replica group.
        Returns the modeled ``ReduceStats`` of a simulator config (on
        ``device``, the stats stored with the frozen plan).
        """
        self._in_lens = [len(i) for i in in_indices]
        self._out_lens = [len(o) for o in out_indices]
        if self.backend == "sim":
            self._sim = SimSparseAllreduce(
                self.plan, replication=self.replication, dead=self.dead,
                perm=self.perm, fabric=self.fabric, value_width=self.width)
            return self._sim.config(out_indices, in_indices)
        if self.wire in LOSSY_WIRE:
            raise NotImplementedError(
                f"the planned reduce path ships pre-routed values only (no "
                f"index stream), and quantized planned payloads are not "
                f"implemented; wire={self.wire!r} is only supported on the "
                f"union path (union_reduce)")
        r, m_phys = self.replication, self.num_physical
        # raises DeadLogicalNode before anything is planned or bound
        first_alive = first_alive_replicas(m_phys, r, self.dead)
        device = self._device()
        fp = autotune.planned_fingerprint(
            device, self.nodes, self.plan.degrees, r, self.dead, self.width,
            self.perm, out_indices, in_indices, fabric=self.fabric)
        memo = autotune.memo_lookup(fp)
        if memo is not None:
            self._planned, self._reduce_fn, stats = memo
            self.config_cache = "memo"
        else:
            planned, stats = self._config_from_disk(fp)
            if planned is None:
                planned, stats = self._config_fresh(fp, out_indices,
                                                    in_indices)
            self._planned = planned
            self._reduce_fn = planned.make_reduce_fn(device)
            autotune.memo_store(fp, (planned, self._reduce_fn, stats))
        self._first_alive = first_alive
        self._repair_cache = {}
        return stats

    def _config_from_disk(self, fp: str):
        """``(planned, stats)`` from the plan cache, or ``(None, None)``
        (no cache, a miss, or a corrupt entry, which then replans)."""
        if self.plan_cache is None:
            return None, None
        hit = self.plan_cache.load(autotune.planned_cache_key(fp))
        if hit is None:
            return None, None
        meta, arrays = hit
        try:
            planned = autotune.planned_from_artifact(
                arrays, meta, {"nodes": self.plan.degrees})
            stats = autotune.stats_from_meta(meta["stats"])
        except Exception:
            return None, None
        autotune.plan_memo_stats["disk_hits"] += 1
        self.config_cache = "disk"
        return planned, stats

    def _config_fresh(self, fp: str, out_indices, in_indices):
        """Host replan: the frozen routing, its modeled stats (a simulator
        shadow config) and, with a cache, the artifact on disk."""
        r, m_phys = self.replication, self.num_physical
        dplan = make_device_plan(
            [("nodes", m_phys)], {"nodes": self.plan.degrees},
            in_capacity=max(self._out_lens),
            out_capacity=sum(self._out_lens), replication=r)
        planned = plan_sparse_allreduce(
            dplan, out_indices, in_indices, perm=self.perm, width=self.width,
            dead=self.dead)
        shadow = SimSparseAllreduce(
            self.plan, replication=r, dead=self.dead, perm=self.perm,
            fabric=self.fabric, value_width=self.width)
        stats = shadow.config(out_indices, in_indices)
        self.config_cache = "fresh"
        if self.plan_cache is not None:
            arrays, meta = autotune.planned_to_artifact(planned)
            meta["stats"] = autotune.stats_to_meta(stats)
            meta["staging"] = {
                "u_cap": planned.u_cap, "uin_cap": planned.uin_cap,
                "out_lens": list(self._out_lens),
                "in_lens": list(self._in_lens),
                "num_physical": m_phys, "nodes": list(self.nodes),
                "degrees": list(self.plan.degrees)}
            self.plan_cache.store(autotune.planned_cache_key(fp), meta,
                                  arrays)
        return planned, stats

    # ------------------------------------------------------------------
    def reconfig_dead(self, dead: Optional[Set[int]]) -> None:
        """Incremental repair (device backend): swap the dead set without
        host replanning -- ``PlannedSparseAllreduce.with_dead``, which
        changes only the contribution weights; the first-alive read-back
        rows change with them.  Repaired plans are cached per dead set.

        Raises ``DeadLogicalNode`` when ``dead`` kills a whole replica
        group, *before* any state changes, so the instance stays usable
        with its previous dead set.  Afterwards ``config_cache`` reads
        ``"repair"``."""
        if self.backend != "device":
            raise ValueError("reconfig_dead() requires backend='device'")
        if self._planned is None:
            raise RuntimeError("call config() before reconfig_dead()")
        first_alive = first_alive_replicas(self.num_physical,
                                           self.replication, dead)
        key = frozenset(dead or ())
        hit = self._repair_cache.get(key)
        if hit is None:
            planned = self._planned.with_dead(dead)
            hit = (planned, planned.make_reduce_fn(self._device()))
            self._repair_cache[key] = hit
        self._planned, self._reduce_fn = hit
        self._first_alive = first_alive
        self.dead = set(key) or None
        self.config_cache = "repair"

    # ------------------------------------------------------------------
    def reduce(self, out_values: Sequence[np.ndarray]) -> List[np.ndarray]:
        """``out_values``: one array per *logical* node, as declared at
        ``config``; returns each node's requested values (numpy).  With
        replication the values are staged onto every replica (dead and
        non-first replicas weigh 0 on the device) and each logical result
        is read back from its first alive replica."""
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
        if self.replication > 1:
            staging = np.concatenate([staging] * self.replication)
        out = self._reduce_fn(torch.from_numpy(staging)).cpu().numpy()
        return [out[self._first_alive[n], : self._in_lens[n]]
                for n in range(self.num_nodes)]

    # ------------------------------------------------------------------
    @obs.span("union.reduce")
    def union_reduce(self, idx, val, out_capacity: int):
        """Gather-all union sum with dynamic indices (the paper's
        mini-batch mode) over the stacked mesh, honouring ``merge``.

        idx: [num_nodes, C] *hashed, sorted*, SENTINEL-padded indices
        (uint32 numpy or an integer tensor); val: [num_nodes, C] or
        [num_nodes, C, W], one chunk per *logical* node.  With
        ``replication=r`` the chunks are mirrored onto the ``r *
        num_nodes`` physical nodes, the ``contribution_weights`` of this
        instance's ``dead`` set are applied, and each logical result is
        read from its shard's first alive replica; raises
        ``DeadLogicalNode`` when a replica group is lost.  Returns torch
        tensors on the bound device: (idx int64 [num_nodes,
        out_capacity], val, overflow [num_nodes]) -- every node gets the
        full union sum.  The device plan and its transport are cached per
        (shape, out_capacity).  ``merge`` alone picks the plain
        (``"sort"``) or a kernel (``"fused"``, ``"banded"``) merge -- the
        reference's ``use_kernel`` argument is not taken -- and ``wire``
        the exchanged payload.
        """
        r, m_phys = self.replication, self.num_physical
        dev = self._device()
        obs.count_htod("union.htod_copies", dev, _host_inputs(idx, val))
        idx = as_index_tensor(idx, dev)
        val = torch.as_tensor(val, device=dev)
        if idx.shape[0] != self.num_nodes:
            raise ValueError(
                f"union_reduce: expected {self.num_nodes} chunks, got "
                f"{idx.shape[0]}")
        if r > 1:
            idx = idx.repeat((r,) + (1,) * (idx.ndim - 1))
            val = val.repeat((r,) + (1,) * (val.ndim - 1))
        key = (tuple(idx.shape), out_capacity, str(dev))
        hit = self._union_cache.get(key)
        if hit is not None:
            self.union_plan_stats["hits"] += 1
        else:
            self.union_plan_stats["misses"] += 1
            dplan = make_device_plan(
                [("nodes", m_phys)], {"nodes": self.plan.degrees},
                in_capacity=idx.shape[1], out_capacity=out_capacity,
                replication=r)
            hit = self._union_cache[key] = (
                dplan, StackedTransport(dplan.logical, dev))
        dplan, transport = hit
        oi, ov, ovf = run_union_allreduce(dplan, idx, val, merge=self.merge,
                                          wire=self.wire, transport=transport,
                                          dead=self.dead)
        if r > 1:
            obs.count_htod("union.htod_copies", dev)
            fa = torch.as_tensor(first_alive_replicas(m_phys, r, self.dead),
                                 device=dev)
            oi, ov, ovf = oi[fa], ov[fa], ovf[fa]
        return oi, ov, ovf

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
            "first_alive": [int(p) for p in self._first_alive],
            "num_physical": self.num_physical,
        }

    @property
    def stats(self) -> Optional[ReduceStats]:
        """Message-level :class:`ReduceStats` of the last :meth:`reduce`
        (sim backend only)."""
        if self.backend == "sim" and self._sim is not None:
            return getattr(self._sim, "reduce_stats", None)
        return None


def _host_inputs(*xs) -> int:
    """How many of ``xs`` are host arrays or CPU tensors: each is one
    host-to-device copy onto a card (``union.htod_copies``)."""
    return sum(not isinstance(x, torch.Tensor) or x.device.type == "cpu"
               for x in xs)
