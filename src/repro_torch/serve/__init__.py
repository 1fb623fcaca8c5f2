"""The serving tier over the port's model stack (reference: ``repro.serve``).

Continuous-batching decode over the training stack's models, with
admission control in front and the paper's sparse exchange underneath:

  * :mod:`repro_torch.serve.queue`      -- token bucket, bounded FIFO,
    circuit breaker, and the :class:`~repro_torch.serve.queue.
    AdmissionController` composing them (deterministic injected clock,
    no sleeps).
  * :mod:`repro_torch.serve.scheduler`  -- slot-based continuous batching
    (join-on-free-slot prefill, evict-on-EOS) over the fused greedy
    prefill / decode steps of ``repro_torch.train.step``.
  * :mod:`repro_torch.serve.dispatch`   -- the Zipf token / expert
    exchange routed through ``SparseAllreduce``: frozen-plan hot set plus
    the shape-bucketed union path for the tail.
  * :mod:`repro_torch.serve.service`    -- the virtual-clock service loop
    tying admission to the scheduler, and the Zipf request stream.

Request-level correctness (continuous-batched == sequential oracle,
token for token) is held by ``tests/test_torch_serve_tier.py`` on the
CPU and by ``chip_smoke.py``'s serve phases on the card.
"""
from .queue import (AdmissionController, BoundedQueue, CircuitBreaker,
                    Request, TokenBucket)
from .scheduler import ContinuousBatchingScheduler
from .service import DecodeService, zipf_request_stream

__all__ = [
    "AdmissionController", "BoundedQueue", "CircuitBreaker", "Request",
    "TokenBucket", "ContinuousBatchingScheduler", "DecodeService",
    "zipf_request_stream",
]
