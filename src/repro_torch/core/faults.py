"""Deterministic failure-injection schedules (reference: ``repro.core.faults``).

Paper §V test harness, host numpy.  One :class:`FailureSchedule` is a
seeded, replayable sequence of dead *physical* node sets; the same
(kind, m, f, seed, step) gives the same set as the reference's, so the
port's tests, the simulator and ``chip_smoke.py`` see the reference's
failures.  Four kinds:

  * ``"random"``  -- ``num_failures`` nodes drawn uniformly without
    replacement, fresh per step (the paper's §V-A failure model);
  * ``"rack"``    -- whole racks of ``rack_size`` consecutive physical ids
    die together (replica groups stride the id space by M, so a rack
    rarely kills a group);
  * ``"rolling"`` -- a contiguous window of ``num_failures`` ids sliding
    with the step;
  * ``"cascade"`` -- ``num_failures`` *new* nodes die each step, from one
    seeded permutation, so ``dead_at(t)`` contains ``dead_at(t - 1)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Set

import numpy as np

from .replication import DeadLogicalNode, contribution_weights

SCHEDULE_KINDS = ("random", "rack", "rolling", "cascade")


@dataclasses.dataclass(frozen=True)
class FailureSchedule:
    """Seeded deterministic sequence of dead physical-node sets."""

    kind: str
    m_physical: int
    num_failures: int
    seed: int = 0
    rack_size: int = 4

    def __post_init__(self):
        if self.kind not in SCHEDULE_KINDS:
            raise ValueError(
                f"kind must be one of {SCHEDULE_KINDS}, got {self.kind!r}")
        if not 0 <= self.num_failures <= self.m_physical:
            raise ValueError(
                f"num_failures={self.num_failures} outside "
                f"[0, {self.m_physical}]")
        if self.kind == "rack" and self.rack_size < 1:
            raise ValueError(f"rack_size must be >= 1, got {self.rack_size}")
        if self.kind == "rack" and self.rack_size > self.m_physical:
            raise ValueError(
                f"impossible rack schedule: rack_size={self.rack_size} "
                f"exceeds m_physical={self.m_physical} — one rack would "
                f"cover the whole fleet and then some")

    # ------------------------------------------------------------------
    def _rng(self, step: int) -> np.random.RandomState:
        # Distinct, replayable stream per (seed, step); constants are
        # arbitrary odd primes to decorrelate the two coordinates.
        return np.random.RandomState(
            (self.seed * 1_000_003 + step * 7919 + 0x5EED) % (2 ** 31 - 1))

    def dead_at(self, step: int = 0) -> Set[int]:
        """The dead set at ``step`` (same (kind, m, f, seed, step) -> same
        set, across processes and calls)."""
        f, m = self.num_failures, self.m_physical
        if f == 0:
            return set()
        if self.kind == "random":
            rng = self._rng(step)
            return set(rng.choice(m, size=f, replace=False).tolist())
        if self.kind == "rack":
            n_racks = -(-m // self.rack_size)
            order = self._rng(step).permutation(n_racks)
            dead: Set[int] = set()
            for rack in order:
                members = [d for d in range(rack * self.rack_size,
                                            min((rack + 1) * self.rack_size, m))]
                take = members[: f - len(dead)]
                dead.update(take)
                if len(dead) >= f:
                    break
            return dead
        if self.kind == "cascade":
            # Monotone accumulation: one seed-only permutation fixes the
            # death order; step t exposes its first (t+1)*f entries, so
            # dead sets are nested supersets and never heal.
            order = self._rng(0).permutation(m)
            return set(order[: min((step + 1) * f, m)].tolist())
        # rolling: contiguous window advancing one failure-width per step
        start = (self.seed + step * f) % m
        return {(start + i) % m for i in range(f)}

    def steps(self, n: int) -> Iterator[Set[int]]:
        """The first ``n`` dead sets of the schedule."""
        for t in range(n):
            yield self.dead_at(t)


def make_schedule(kind: str, m_physical: int, num_failures: int,
                  seed: int = 0, rack_size: int = 4) -> FailureSchedule:
    """Convenience constructor mirroring the dataclass."""
    return FailureSchedule(kind=kind, m_physical=m_physical,
                           num_failures=num_failures, seed=seed,
                           rack_size=rack_size)


def analytic_completion_probability(m_logical: int, replication: int,
                                    num_failures: int) -> float:
    """Poissonized generalized-birthday estimate of P[protocol completes]
    under ``num_failures`` random dead physical nodes.

    A specific group is fully dead with probability
    prod_{t<r} (f-t)/(m_phys-t) (all r replicas among the f failed nodes,
    sampling without replacement); the dead-group count is ~Poisson with
    mean lambda = M * that, so P[complete] ~ exp(-lambda).  Degenerate at
    r=1 where every failure is its own dead group (exact P is 0 for any
    f >= 1).
    """
    r, f = replication, num_failures
    if f < r:
        return 1.0
    m_phys = m_logical * r
    p_group = 1.0
    for t in range(r):
        p_group *= (f - t) / (m_phys - t)
    return math.exp(-m_logical * p_group)


def completion_probability(m_logical: int, replication: int,
                           num_failures: int, *, trials: int = 1000,
                           kind: str = "random", seed: int = 0,
                           rack_size: int = 4) -> float:
    """Empirical P[protocol completes] over ``trials`` schedule steps.

    A trial completes iff no replica group is entirely dead, i.e.
    :func:`repro_torch.core.replication.contribution_weights` does not raise
    :class:`DeadLogicalNode` — exactly the condition under which both the
    simulator and the device backend accept the failure set.
    """
    m_phys = m_logical * replication
    sched = FailureSchedule(kind=kind, m_physical=m_phys,
                            num_failures=num_failures, seed=seed,
                            rack_size=rack_size)
    ok = 0
    for dead in sched.steps(trials):
        try:
            contribution_weights(m_phys, replication, dead)
            ok += 1
        except DeadLogicalNode:  # noqa: RA501 — counting, not swallowing
            pass
    return ok / trials
