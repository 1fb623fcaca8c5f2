"""Supervised sparse allreduce: faults in, degraded-but-correct results out (reference: ``repro.resilience.supervisor``).

:class:`ResilientAllreduce` wraps the device-backend
:class:`repro_torch.core.api.SparseAllreduce` with the supervision loop:

1. **Detect and classify** -- before every reduce the supervisor reads the
   active dead set (a ``probe`` callable, a
   :class:`~repro_torch.core.faults.FailureSchedule`, or a static set)
   and classifies it (:func:`repro_torch.resilience.events.classify`); a
   ``DeadLogicalNode`` escaping the wrapped reduce is re-classified the
   same way.
2. **Retry with bounded exponential backoff** -- a group-lost event may
   be transient, so it is re-probed up to ``max_retries`` times, sleeping
   ``backoff_s * backoff_mult**attempt`` between probes
   (:func:`retry_until_alive`, with an injectable ``sleep``).
3. **Degrade per policy** -- ``mode="shrink"`` replans over the surviving
   logical shards (keeping replication when enough nodes survive),
   ``"drop_replication"`` shrinks to r = 1, ``"fail"`` re-raises.  The
   survivors' results equal a fresh fault-free reduce over the same set,
   bit for bit.

Replica-absorbed events are a weights-only repair (no replan); survivor
replans resolve their degrees through the plan cache with
``shrunk_from`` (``repro_torch.core.autotune``) and are kept per
survivor set, so a repeat shrink reuses the survivor instance.

The fleet is a pool of node positions (``pool``: a count or a list;
default ``range(num_physical)``), the stand-in for the reference's mesh
devices: physical node i runs at ``pool[i]``, and a survivor instance
takes the positions of the first alive ones.  On one card the positions
change no computation (``SparseAllreduce``'s ``nodes=``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.api import SparseAllreduce
from repro_torch.core.faults import FailureSchedule
from repro_torch.core.netmodel import EC2_2013, Fabric
from repro_torch.core.replication import DeadLogicalNode
from repro_torch.core.topology import tune
from .events import (GROUP_LOST, NO_FAULT, QUORUM_LOST, REPLICA_ABSORBED,
                     FaultEvent, QuorumLost, classify)

#: Degraded-mode policies, in decreasing willingness to continue.
POLICY_MODES = ("shrink", "drop_replication", "fail")


@dataclasses.dataclass(frozen=True)
class DegradedPolicy:
    """What the supervisor does when a replica group stays dead: ``mode``
    ``"shrink"`` (replan over survivors, keeping replication when the
    surviving node count allows), ``"drop_replication"`` (replan over
    survivors at r = 1), ``"fail"`` (re-raise ``DeadLogicalNode`` after
    retries).  Retries and quorum apply to every mode."""

    mode: str = "shrink"
    max_retries: int = 3
    backoff_s: float = 0.05
    backoff_mult: float = 2.0
    quorum_frac: float = 0.5

    def __post_init__(self):
        if self.mode not in POLICY_MODES:
            raise ValueError(
                f"mode must be one of {POLICY_MODES}, got {self.mode!r}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got "
                             f"{self.max_retries}")
        if self.backoff_s < 0:
            raise ValueError(f"backoff_s must be >= 0, got {self.backoff_s}")
        if self.backoff_mult < 1.0:
            raise ValueError(
                f"backoff_mult must be >= 1, got {self.backoff_mult}")
        if not 0.0 < self.quorum_frac <= 1.0:
            raise ValueError(
                f"quorum_frac must be in (0, 1], got {self.quorum_frac}")


def retry_until_alive(dead_at: Callable[[int], Optional[Set[int]]],
                      policy: DegradedPolicy, m_physical: int,
                      replication: int, *,
                      step: int = 0,
                      sleep: Callable[[float], None] = time.sleep
                      ) -> Tuple[FaultEvent, List[FaultEvent]]:
    """Probe ``dead_at(attempt)`` until the fault clears or retries run
    out, sleeping ``backoff_s * backoff_mult**attempt`` between probes.
    Returns ``(final_event, all_events)``: the first event that is not
    group-lost, or the last group-lost one after ``max_retries`` extra
    probes."""
    events: List[FaultEvent] = []
    for attempt in range(policy.max_retries + 1):
        ev = classify(m_physical, replication, dead_at(attempt),
                      quorum_frac=policy.quorum_frac,
                      step=step, attempt=attempt)
        events.append(ev)
        if ev.klass != GROUP_LOST:
            return ev, events
        if attempt < policy.max_retries:
            sleep(policy.backoff_s * policy.backoff_mult ** attempt)
    return events[-1], events


@dataclasses.dataclass
class ReduceOutcome:
    """One supervised reduce: results keyed by *original* logical shard
    id (every shard when ``degraded`` is False; lost shards are absent)
    plus provenance; ``shrink`` is :attr:`ResilientAllreduce.last_shrink`
    when a replan happened."""

    values: Dict[int, object]
    event: FaultEvent
    degraded: bool
    attempts: int
    shrink: Optional[dict] = None


def pool_positions(pool, count: int) -> List[int]:
    """The fleet's node positions: ``pool`` as a count or a list, default
    ``range(count)``; raises ``ValueError`` when it holds fewer than
    ``count``."""
    positions = list(range(count)) if pool is None else (
        list(range(pool)) if isinstance(pool, int)
        else [int(p) for p in pool])
    if len(positions) < count:
        raise ValueError(f"pool of {len(positions)} positions < {count} "
                         f"needed")
    return positions


class ResilientAllreduce:
    """Supervised two-call sparse allreduce (module docstring): the
    ``config`` / ``reduce`` shape of :class:`SparseAllreduce` (device
    backend) plus a fault source -- ``schedule`` (consulted at
    ``dead_at(step)``), ``probe`` ``(step, attempt) -> dead set``
    (overrides the schedule; retries re-probe), or a static ``dead``
    set.  ``reduce`` / ``union_reduce`` return :class:`ReduceOutcome`."""

    def __init__(self, num_nodes: int, degrees="auto", *,
                 replication: int = 1,
                 schedule: Optional[FailureSchedule] = None,
                 probe: Optional[Callable] = None,
                 dead: Optional[Set[int]] = None,
                 policy: Optional[DegradedPolicy] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 pool=None, device=None, seed: int = 0,
                 value_width: int = 1, merge: str = "sort",
                 fabric: Fabric = EC2_2013,
                 expected_nnz: float = 1e5, index_range: float = 1e6,
                 plan_cache=True, retune: bool = False):
        self.policy = policy or DegradedPolicy()
        self.schedule = schedule
        self.probe = probe
        self.static_dead = set(dead or ())
        self.sleep = sleep
        self.num_nodes = num_nodes
        self.replication = replication
        self.seed = seed
        self.merge = merge
        self.fabric = fabric
        self.expected_nnz = expected_nnz
        self.index_range = index_range
        self.device = device
        self.pool = pool_positions(pool, num_nodes * replication)
        # the base instance is fault-free at config time; dead sets are
        # applied per reduce through reconfig_dead (incremental repair)
        self.base = SparseAllreduce(
            num_nodes, degrees, backend="device", replication=replication,
            dead=None, fabric=fabric, seed=seed, value_width=value_width,
            device=device, expected_nnz=expected_nnz,
            index_range=index_range, merge=merge, plan_cache=plan_cache,
            retune=retune, nodes=self.pool[: self.num_physical])
        self._out_indices = self._in_indices = None
        self._shrunk: Dict[Tuple[Tuple[int, ...], int],
                           Tuple[SparseAllreduce, dict]] = {}
        self.last_shrink: Optional[dict] = None
        self.events: List[FaultEvent] = []
        self.stats = {"reduces": 0, "absorbed": 0, "repairs": 0,
                      "retries": 0, "shrinks": 0, "shrink_reuses": 0,
                      "quorum_lost": 0}

    @property
    def num_physical(self) -> int:
        """Physical node count of the un-degraded fleet."""
        return self.num_nodes * self.replication

    # ------------------------------------------------------------------
    def config(self, out_indices: Sequence[np.ndarray],
               in_indices: Sequence[np.ndarray]):
        """The paper's ``config``: freeze routing for the fault-free fleet
        and keep the logical index lists for survivor replans."""
        self._out_indices = [np.asarray(o, np.uint32) for o in out_indices]
        self._in_indices = [np.asarray(i, np.uint32) for i in in_indices]
        return self.base.config(self._out_indices, self._in_indices)

    # ------------------------------------------------------------------
    def _dead_at(self, step: int, attempt: int) -> Set[int]:
        if self.probe is not None:
            return set(self.probe(step, attempt) or ())
        if self.schedule is not None:
            return set(self.schedule.dead_at(step))
        return set(self.static_dead)

    def _supervise(self, step: int) -> FaultEvent:
        """Detection + retry/backoff; raises :class:`QuorumLost`, or
        ``DeadLogicalNode`` under ``mode="fail"``, when unrecoverable."""
        ev, evs = retry_until_alive(
            lambda a: self._dead_at(step, a), self.policy,
            self.num_physical, self.replication, step=step,
            sleep=self.sleep)
        self.events.extend(evs)
        self.stats["retries"] += len(evs) - 1
        if ev.klass == QUORUM_LOST:
            self.stats["quorum_lost"] += 1
            raise QuorumLost(
                f"step {step}: only {len(ev.survivors)} of "
                f"{self.num_nodes} logical shards survive "
                f"(quorum_frac={self.policy.quorum_frac}, "
                f"dead={sorted(ev.dead)})")
        if ev.klass == GROUP_LOST and self.policy.mode == "fail":
            raise DeadLogicalNode(
                f"step {step}: replica groups {list(ev.lost)} lost after "
                f"{self.policy.max_retries} retries and policy is "
                f"mode='fail' (dead={sorted(ev.dead)})")
        return ev

    # ------------------------------------------------------------------
    def _shrink_for(self, ev: FaultEvent) -> Tuple[SparseAllreduce,
                                                   Tuple[int, ...]]:
        """The survivor instance for ``ev`` (kept per survivor set)."""
        survivors = ev.survivors
        m2 = len(survivors)
        alive = [i for i in range(self.num_physical) if i not in ev.dead]
        if self.policy.mode == "drop_replication":
            r2 = 1
        else:
            r2 = self.replication if m2 * self.replication <= len(alive) \
                else 1
        key = (survivors, r2)
        hit = self._shrunk.get(key)
        if hit is not None:
            self.stats["shrink_reuses"] += 1
            self.last_shrink = hit[1]
            return hit[0], survivors
        degrees, source = self._survivor_degrees(m2, r2)
        ar2 = SparseAllreduce(
            m2, degrees, backend="device", replication=r2, dead=None,
            fabric=self.fabric, seed=self.seed, value_width=self.base.width,
            device=self.device, expected_nnz=self.expected_nnz,
            index_range=self.index_range, merge=self.merge,
            plan_cache=self.base.plan_cache or False,
            nodes=[self.pool[i] for i in alive[: m2 * r2]])
        if self._out_indices is not None:
            ar2.config([self._out_indices[i] for i in survivors],
                       [self._in_indices[i] for i in survivors])
        record = {"survivors": survivors, "degrees": tuple(degrees),
                  "replication": r2, "degrees_source": source,
                  "config_cache": ar2.config_cache,
                  "nodes": ar2.nodes}
        self._shrunk[key] = (ar2, record)
        self.last_shrink = record
        self.stats["shrinks"] += 1
        return ar2, survivors

    def _survivor_degrees(self, m2: int, r2: int):
        if m2 == 1:
            return (), "trivial"
        if self.base.degrees_source == "explicit" or \
                self.base.plan_cache is None:
            return tune(m2, n0=self.expected_nnz,
                        total_range=self.index_range,
                        fabric=self.fabric).degrees, "tuned"
        from repro_torch.core.autotune import resolve_degrees
        return resolve_degrees(
            m2, n0=self.expected_nnz, total_range=self.index_range,
            fabric=self.fabric, merge=self.merge, replication=r2,
            width=self.base.width, cache=self.base.plan_cache,
            shrunk_from=self.num_nodes)

    def _absorb(self, ev: FaultEvent) -> None:
        """Bring the base instance to ``ev``'s dead set (a weights-only
        repair when it is configured)."""
        if set(ev.dead) != set(self.base.dead or ()):
            if self.base._planned is not None:
                self.base.reconfig_dead(set(ev.dead) or None)
            else:
                # the union path applies the dead set per call
                self.base.dead = set(ev.dead) or None
            self.stats["repairs"] += 1
        if ev.klass == REPLICA_ABSORBED:
            self.stats["absorbed"] += 1

    # ------------------------------------------------------------------
    def reduce(self, out_values: Sequence[np.ndarray],
               step: int = 0) -> ReduceOutcome:
        """Supervised planned reduce at ``step``: ``values[i]`` is logical
        shard i's result (numpy)."""
        self.stats["reduces"] += 1
        ev = self._supervise(step)
        attempts = ev.attempt
        if ev.klass in (NO_FAULT, REPLICA_ABSORBED):
            try:
                self._absorb(ev)
                vals = self.base.reduce(out_values)
                return ReduceOutcome(
                    values=dict(enumerate(vals)), event=ev,
                    degraded=False, attempts=attempts)
            except DeadLogicalNode:
                # the fault raced past the probe: fall through to degraded
                ev = dataclasses.replace(ev, klass=GROUP_LOST)
                if self.policy.mode == "fail":
                    raise
        ar2, survivors = self._shrink_for(ev)
        vals2 = ar2.reduce([out_values[i] for i in survivors])
        return ReduceOutcome(
            values={sid: vals2[k] for k, sid in enumerate(survivors)},
            event=ev, degraded=True, attempts=attempts,
            shrink=self.last_shrink)

    # ------------------------------------------------------------------
    def union_reduce(self, idx, val, out_capacity: int,
                     step: int = 0) -> ReduceOutcome:
        """Supervised dynamic-index union reduce at ``step``:
        ``values[i]`` is the ``(idx, val, overflow)`` row triple (tensors
        on the bound device) of surviving logical node i.  ``merge``
        picks the plain or a kernel merge, as in
        ``SparseAllreduce.union_reduce``."""
        self.stats["reduces"] += 1
        ev = self._supervise(step)
        attempts = ev.attempt
        if ev.klass in (NO_FAULT, REPLICA_ABSORBED):
            try:
                self._absorb(ev)
                oi, ov, ovf = self.base.union_reduce(idx, val, out_capacity)
                values = {i: (oi[i], ov[i], ovf[i])
                          for i in range(self.num_nodes)}
                return ReduceOutcome(values=values, event=ev,
                                     degraded=False, attempts=attempts)
            except DeadLogicalNode:
                ev = dataclasses.replace(ev, klass=GROUP_LOST)
                if self.policy.mode == "fail":
                    raise
        ar2, survivors = self._shrink_for(ev)
        rows = list(survivors)
        oi, ov, ovf = ar2.union_reduce(idx[rows], val[rows], out_capacity)
        values = {sid: (oi[k], ov[k], ovf[k])
                  for k, sid in enumerate(survivors)}
        return ReduceOutcome(values=values, event=ev, degraded=True,
                             attempts=attempts, shrink=self.last_shrink)
