"""The decode service loop: admission control in front of the
continuous-batching scheduler, on a deterministic virtual clock
(reference: ``repro.serve.service``).

Time is measured in *decode steps*: every loop tick delivers due
arrivals to the :class:`~repro_torch.serve.queue.AdmissionController`, joins
admitted requests onto free slots, runs one fused decode step, and
advances the clock by 1.  Latencies/SLOs are therefore in steps, and the
whole trajectory — admissions, sheds, breaker trips, token streams — is
a pure function of the request stream, which is what the consistency
harness and the load benches rely on.  Wall time is tracked only for the
tokens/s conversion in :class:`ServiceReport` and never feeds a
decision.

:func:`zipf_request_stream` generates the paper's workload wearing its
serving hat — prompts drawn by ``repro_torch.data.pipeline.zipf_tokens`` (the
same power-law collision statistics the allreduce core is built for),
with seeded exponential inter-arrivals at a configurable offered rate.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.data.pipeline import zipf_tokens

from .queue import AdmissionController, Request
from .scheduler import ContinuousBatchingScheduler


def zipf_request_stream(n: int, vocab: int, *, alpha: float = 1.2,
                        prompt_lens: Tuple[int, ...] = (4, 8, 16),
                        max_new: Tuple[int, int] = (1, 8),
                        arrival_rate: Optional[float] = None,
                        eos_id: Optional[int] = None,
                        seed: int = 0) -> List[Request]:
    """Seeded Zipf request stream: ``n`` requests with prompts drawn from
    ``zipf_tokens``, prompt lengths cycling through ``prompt_lens``,
    ``max_new`` uniform over its inclusive range, and exponential
    inter-arrivals at ``arrival_rate`` requests per step (None: all
    arrive at t=0)."""
    rng = np.random.RandomState(seed)
    reqs = []
    t = 0.0
    lo, hi = max_new
    for i in range(n):
        plen = int(prompt_lens[i % len(prompt_lens)])
        prompt = zipf_tokens(rng, (1, plen), vocab, alpha=alpha)[0]
        if arrival_rate is not None:
            t += float(rng.exponential(1.0 / arrival_rate))
        reqs.append(Request(rid=i, prompt=np.asarray(prompt, np.int32),
                            max_new=int(rng.randint(lo, hi + 1)),
                            eos_id=eos_id, arrival=t))
    return reqs


@dataclasses.dataclass
class ServiceReport:
    """What one service run produced: the completed requests (in
    completion order), latency percentiles over *admitted* requests (in
    steps), throughput, and the admission/dispatch statistics."""
    completed: List[Request]
    steps: int
    tokens_out: int
    wall_s: float
    p50_steps: float
    p99_steps: float
    admission: Optional[object] = None       # AdmissionStats | None
    plan_hit_rate: Optional[float] = None

    @property
    def tokens_per_s(self) -> float:
        """Generated ids per wall second over the run."""
        return self.tokens_out / max(self.wall_s, 1e-9)


def _percentile(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs \
        else 0.0


class DecodeService:
    """Drives a scheduler from a request stream under admission control.

    ``admission=None`` admits everything (the consistency harness runs
    this way: correctness must not depend on load shedding)."""

    def __init__(self, scheduler: ContinuousBatchingScheduler,
                 admission: Optional[AdmissionController] = None):
        self.scheduler = scheduler
        self.admission = admission

    def run(self, requests: List[Request],
            max_steps: int = 100_000) -> ServiceReport:
        """Serve the stream to completion (or ``max_steps``) and report.

        One tick = deliver due arrivals -> join admitted onto free slots
        -> one decode step -> stamp completions -> advance the clock."""
        sched = self.scheduler
        adm = self.admission
        pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
        direct: List[Request] = []        # admission-free FIFO
        completed: List[Request] = []
        t = 0.0
        t0 = time.time()
        while pending or direct or sched.active \
                or (adm is not None and adm.pending()):
            while pending and pending[0].arrival <= t:
                req = pending.pop(0)
                if adm is None:
                    req.admitted_at = t
                    direct.append(req)
                else:
                    adm.offer(req, t)
            queue_next = (lambda: direct.pop(0) if direct else None) \
                if adm is None else adm.next_request
            while sched.free_slots():
                req = queue_next()
                if req is None:
                    break
                sched.join(req)
            sched.step()
            t += 1.0
            for req in sched.pop_completed():
                if adm is None:
                    req.finished_at = t
                else:
                    adm.complete(req, t)
                completed.append(req)
            if t >= max_steps:
                break
        wall = time.time() - t0
        lats = [r.latency for r in completed if r.latency is not None]
        hit = None
        if sched.dispatch is not None:
            hit = sched.dispatch.plan_hit_rate
        return ServiceReport(
            completed=completed, steps=int(t),
            tokens_out=sched.metrics.tokens_out, wall_s=wall,
            p50_steps=_percentile(lats, 50), p99_steps=_percentile(lats, 99),
            admission=adm.stats if adm is not None else None,
            plan_hit_rate=hit)


def run_sequential_oracle(scheduler: ContinuousBatchingScheduler,
                          requests: List[Request]) -> List[List[int]]:
    """The consistency oracle: the same scheduler instance (the same
    slot geometry), one request at a time.

    Returns per-request token lists indexed by position in ``requests``.
    Running through the *same* slot count is the point: another batch
    size runs other matmul shapes, whose kernels may sum in another order
    and differ in the last ulp, which would test the kernels' numerics
    instead of the scheduler's request isolation."""
    out = []
    for req in requests:
        clone = Request(rid=req.rid, prompt=np.array(req.prompt),
                        max_new=req.max_new, eos_id=req.eos_id)
        scheduler.join(clone)
        while scheduler.active:
            scheduler.step()
        scheduler.pop_completed()
        out.append(list(clone.tokens))
    return out
