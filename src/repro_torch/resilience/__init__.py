"""Supervision layer of the PyTorch port: fatal faults to degraded-but-correct continuation (reference: ``repro.resilience``).

* :mod:`repro_torch.resilience.events` -- fault classification
  (replica-absorbed / group-lost / quorum-lost);
* :mod:`repro_torch.resilience.supervisor` -- :class:`ResilientAllreduce`,
  the supervised two-call reduce with retry/backoff and
  replan-over-survivors;
* :mod:`repro_torch.resilience.engine` -- :class:`SupervisedEngineLoop`,
  blocked and checkpointed ``GraphEngine`` runs with remapping.

The kill-and-resume soak harness is ``repro_torch.launch.soak``.
"""
from .events import (FaultEvent, QuorumLost, classify,  # noqa: F401
                     GROUP_LOST, NO_FAULT, QUORUM_LOST, REPLICA_ABSORBED)
from .supervisor import (DegradedPolicy, ReduceOutcome,  # noqa: F401
                         ResilientAllreduce, retry_until_alive)
from .engine import SupervisedEngineLoop  # noqa: F401
