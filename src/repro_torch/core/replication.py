"""r-way replication for fault tolerance (reference: ``repro.core.replication``).

Paper §V.  Logical shard ``i`` of ``M`` lives on physical nodes
``i, i+M, ..., i+(r-1)M``; exactly one alive replica per shard
contributes (weight 1), and a shard whose whole replica group is dead
makes the protocol fail with :class:`DeadLogicalNode`.  The simulator
uses this module; replication on the device backend is a later slice.
"""
from __future__ import annotations

import math
from typing import List, Optional, Set

import numpy as np


class DeadLogicalNode(RuntimeError):
    """All replicas of a logical node are dead — the protocol cannot
    complete (paper §V-A)."""


def replica_groups(m_physical: int, replication: int) -> List[List[int]]:
    """Logical shard i lives on physical nodes i, i+M, ..., i+(r-1)M."""
    if replication < 1:
        raise ValueError(f"replication must be >= 1, got {replication}")
    if m_physical % replication:
        raise ValueError(f"{m_physical} devices not divisible by r={replication}")
    m_logical = m_physical // replication
    return [[i + j * m_logical for j in range(replication)]
            for i in range(m_logical)]


def _check_dead(m_physical: int, dead: Set[int]) -> None:
    bad = dead - set(range(m_physical))
    if bad:
        raise ValueError(
            f"dead ids {sorted(bad)} outside [0, {m_physical}) — failure "
            f"injection would silently be a no-op")


def contribution_weights(m_physical: int, replication: int,
                         dead: Optional[Set[int]] = None) -> np.ndarray:
    """weight[d] = 1.0 iff d is the first alive replica of its logical
    shard; raises :class:`DeadLogicalNode` if a whole group is dead."""
    dead = set(dead or ())
    _check_dead(m_physical, dead)
    w = np.zeros(m_physical, np.float32)
    for group in replica_groups(m_physical, replication):
        alive = [d for d in group if d not in dead]
        if not alive:
            raise DeadLogicalNode(
                f"replica group {group} entirely dead (r={replication})")
        w[alive[0]] = 1.0
    return w


def first_alive_replicas(m_physical: int, replication: int,
                         dead: Optional[Set[int]] = None) -> np.ndarray:
    """[m_logical] physical id of each logical shard's first alive replica."""
    w = contribution_weights(m_physical, replication, dead)
    m_logical = m_physical // replication
    out = np.empty(m_logical, np.int64)
    for p in np.nonzero(w)[0]:
        out[p % m_logical] = p
    return out


def expected_tolerated_failures(m_logical: int, replication: int = 2) -> float:
    """Expected random physical failures before some replica group is
    fully dead: ``Gamma(1 + 1/r) (r!)^(1/r) M^(1 - 1/r)`` (the paper's
    ``sqrt(pi M / 2)`` at r=2)."""
    r = replication
    if r < 1:
        raise ValueError(f"replication must be >= 1, got {r}")
    return (math.gamma(1.0 + 1.0 / r) * math.factorial(r) ** (1.0 / r)
            * m_logical ** (1.0 - 1.0 / r))
