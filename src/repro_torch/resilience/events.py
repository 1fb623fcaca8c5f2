"""Fault-event taxonomy of the supervision layer (reference: ``repro.resilience.events``).

Every dead set the supervisor (:mod:`repro_torch.resilience.supervisor`)
sees is classified into one severity, keyed off the paper's §V replica
layout (:func:`repro_torch.core.replication.replica_groups`):

* **replica-absorbed** -- some physical nodes are dead but every replica
  group keeps an alive member; the reduce completes unchanged after a
  weights-only repair (``SparseAllreduce.reconfig_dead``);
* **group-lost** -- at least one replica group is entirely dead; the
  supervisor replans over the surviving logical shards;
* **quorum-lost** -- fewer than ``quorum_frac`` of the logical shards
  survive; the supervisor fails fast with :class:`QuorumLost`.

:func:`classify` is pure host numpy, so schedule consultation and the
``DeadLogicalNode`` handler agree on severity by construction.
"""
from __future__ import annotations

import dataclasses
import math
from typing import FrozenSet, Optional, Set, Tuple

from repro_torch.core.replication import (DeadLogicalNode,
                                          lost_logical_shards,
                                          surviving_logical_shards)

#: Severity labels, mildest first.
NO_FAULT = "none"
REPLICA_ABSORBED = "replica-absorbed"
GROUP_LOST = "group-lost"
QUORUM_LOST = "quorum-lost"


class QuorumLost(DeadLogicalNode):
    """Too few logical shards survive to continue degraded -- the
    supervisor's fail-fast terminal state (a ``DeadLogicalNode``, so
    callers that already handle dead groups keep working)."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One classified observation of a dead set: ``lost`` / ``survivors``
    are logical shard ids, ``dead`` physical ones; ``attempt`` counts
    retries within one reduce (0 = first try)."""

    step: int
    attempt: int
    dead: FrozenSet[int]
    klass: str
    lost: Tuple[int, ...]
    survivors: Tuple[int, ...]


def classify(m_physical: int, replication: int,
             dead: Optional[Set[int]] = None, *,
             quorum_frac: float = 0.5,
             step: int = 0, attempt: int = 0) -> FaultEvent:
    """Classify a dead physical-node set: the run continues degraded
    while at least ``max(1, ceil(quorum_frac * m_logical))`` logical
    shards survive, below that it is :data:`QUORUM_LOST`.  Raises
    ``ValueError`` for out-of-range dead ids."""
    dead = set(dead or ())
    lost = tuple(lost_logical_shards(m_physical, replication, dead))
    survivors = tuple(surviving_logical_shards(m_physical, replication, dead))
    m_logical = m_physical // replication
    if not dead:
        klass = NO_FAULT
    elif not lost:
        klass = REPLICA_ABSORBED
    elif len(survivors) < max(1, math.ceil(quorum_frac * m_logical)):
        klass = QUORUM_LOST
    else:
        klass = GROUP_LOST
    return FaultEvent(step=step, attempt=attempt, dead=frozenset(dead),
                      klass=klass, lost=lost, survivors=survivors)
