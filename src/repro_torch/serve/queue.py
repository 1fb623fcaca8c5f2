"""Admission control for the serving tier: token-bucket rate limiting, a
bounded FIFO with load shedding, and a latency circuit breaker (reference:
``repro.serve.queue``, copied: pure Python and numpy, no device).

Every primitive takes time as an explicit ``now`` argument (any monotone
float clock); nothing here reads a wall clock or sleeps.  The service
drives these with a *virtual* clock measured in decode steps, which is
what makes the admission property tests deterministic
(``tests/test_torch_serve_tier.py`` holds this copy to the reference's,
offer by offer).

The contract each piece keeps (hypothesis-checked):

  * :class:`TokenBucket` — over any window ``(t0, t1]`` it admits at most
    ``burst + rate * (t1 - t0)`` unit-cost requests.
  * :class:`BoundedQueue` — FIFO for admitted items, and
    ``admitted + shed == offered`` at all times.
  * :class:`CircuitBreaker` — trips only after ``breach_window``
    *consecutive* SLO breaches, always half-opens after ``cooldown``,
    and can never deadlock refusing (lost probes re-arm after another
    cooldown).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    """One decode request: a prompt in, up to ``max_new`` greedy ids out.

    ``arrival`` / ``admitted_at`` / ``finished_at`` are service-clock
    stamps (decode steps under the virtual clock); ``tokens`` accumulates
    the generated ids, including the EOS id when one stops the request.
    """
    rid: int
    prompt: np.ndarray
    max_new: int
    eos_id: Optional[int] = None
    arrival: float = 0.0
    admitted_at: Optional[float] = None
    finished_at: Optional[float] = None
    tokens: List[int] = dataclasses.field(default_factory=list)

    @property
    def latency(self) -> Optional[float]:
        """Arrival-to-finish latency in clock units (None while open)."""
        if self.finished_at is None:
            return None
        return self.finished_at - self.arrival

    def done(self) -> bool:
        """True once EOS was emitted or ``max_new`` ids were generated."""
        if len(self.tokens) >= self.max_new:
            return True
        return bool(self.tokens) and self.eos_id is not None \
            and self.tokens[-1] == self.eos_id


class TokenBucket:
    """Classic token bucket: capacity ``burst``, refill ``rate`` per unit
    time, one token per unit-cost admit.

    The invariant the property tests pin: the number of successful
    ``admit(now)`` calls with times inside any window ``(t0, t1]`` is at
    most ``burst + rate * (t1 - t0)`` — tokens held at ``t0`` are capped
    by ``burst`` and refill inside the window is ``rate * (t1 - t0)``.
    Time may not run backwards; a stale ``now`` is clamped forward.
    """

    def __init__(self, rate: float, burst: float):
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        if burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._last: Optional[float] = None

    def admit(self, now: float, cost: float = 1.0) -> bool:
        """Try to take ``cost`` tokens at time ``now``."""
        if self._last is None:
            self._last = now
        now = max(now, self._last)
        self._tokens = min(self.burst,
                           self._tokens + (now - self._last) * self.rate)
        self._last = now
        if self._tokens + 1e-12 >= cost:
            self._tokens -= cost
            return True
        return False


class BoundedQueue:
    """Bounded FIFO with shed counters: full queue sheds, never blocks."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._q: Deque = deque()
        self.offered = 0
        self.admitted = 0
        self.shed = 0

    def offer(self, item) -> bool:
        """Enqueue unless full; counts every call as offered."""
        self.offered += 1
        if len(self._q) >= self.capacity:
            self.shed += 1
            return False
        self._q.append(item)
        self.admitted += 1
        return True

    def pop(self):
        """Dequeue the oldest admitted item (None when empty)."""
        return self._q.popleft() if self._q else None

    def __len__(self) -> int:
        return len(self._q)


class CircuitBreaker:
    """Latency circuit breaker: closed -> open on sustained SLO breach,
    open -> half-open after ``cooldown``, half-open -> closed on
    ``probes`` consecutive probe successes (any probe breach re-opens).

    * Trips only after ``breach_window`` *consecutive* completions over
      ``slo`` while closed (one good completion resets the streak).
    * While open, ``allow`` refuses until ``cooldown`` has elapsed, then
      the breaker half-opens and admits up to ``probes`` probe requests.
    * Liveness: if every in-flight probe is lost (its completion never
      recorded), the probe budget re-arms after another ``cooldown`` —
      the breaker can never deadlock refusing forever.

    Completions recorded while open (stragglers admitted before the
    trip) are ignored: they describe the overloaded past, not the probe.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, slo: float, *, breach_window: int = 8,
                 cooldown: float = 16.0, probes: int = 2):
        if slo <= 0:
            raise ValueError(f"slo must be > 0, got {slo}")
        if breach_window < 1:
            raise ValueError(
                f"breach_window must be >= 1, got {breach_window}")
        if cooldown <= 0:
            raise ValueError(f"cooldown must be > 0, got {cooldown}")
        if probes < 1:
            raise ValueError(f"probes must be >= 1, got {probes}")
        self.slo = float(slo)
        self.breach_window = int(breach_window)
        self.cooldown = float(cooldown)
        self.probes = int(probes)
        self.state = self.CLOSED
        self.trips = 0
        self._streak = 0
        self._opened_at: Optional[float] = None
        self._half_opened_at: Optional[float] = None
        self._probe_sent = 0
        self._probe_ok = 0

    def allow(self, now: float) -> bool:
        """May a request be admitted at ``now``?  (Half-open admits count
        against the probe budget.)"""
        if self.state == self.OPEN:
            if now - self._opened_at >= self.cooldown:
                self._half_open(now)
            else:
                return False
        if self.state == self.HALF_OPEN:
            if self._probe_sent >= self.probes \
                    and now - self._half_opened_at >= self.cooldown:
                self._half_open(now)      # probes lost in flight: re-arm
            if self._probe_sent < self.probes:
                self._probe_sent += 1
                return True
            return False
        return True

    def record(self, now: float, latency: float) -> None:
        """Feed one completed request's latency back into the breaker."""
        breach = latency > self.slo
        if self.state == self.CLOSED:
            self._streak = self._streak + 1 if breach else 0
            if self._streak >= self.breach_window:
                self._trip(now)
        elif self.state == self.HALF_OPEN:
            if breach:
                self._trip(now)
            else:
                self._probe_ok += 1
                if self._probe_ok >= self.probes:
                    self.state = self.CLOSED
                    self._streak = 0

    def _trip(self, now: float) -> None:
        self.state = self.OPEN
        self._opened_at = now
        self._streak = 0
        self.trips += 1

    def _half_open(self, now: float) -> None:
        self.state = self.HALF_OPEN
        self._half_opened_at = now
        self._probe_sent = 0
        self._probe_ok = 0


@dataclasses.dataclass
class AdmissionStats:
    """Per-reason admission counters; ``offered`` equals the sum of
    ``admitted`` and the three shed counters at all times."""
    offered: int = 0
    admitted: int = 0
    shed_rate: int = 0
    shed_queue: int = 0
    shed_breaker: int = 0

    @property
    def shed(self) -> int:
        """Total shed across all reasons."""
        return self.shed_rate + self.shed_queue + self.shed_breaker


class AdmissionController:
    """Breaker -> token bucket -> bounded queue, in that order.

    The breaker is consulted first (an open breaker sheds before any
    token is spent), the bucket second (so rate-shed requests never
    occupy queue slots), the queue last.  A half-open probe slot can be
    consumed by a request the bucket then sheds; the breaker's re-arm
    cooldown guarantees that leak cannot wedge it (see
    :class:`CircuitBreaker`).
    """

    def __init__(self, *, rate: float, burst: float, queue_cap: int,
                 slo: float, breach_window: int = 8, cooldown: float = 16.0,
                 probes: int = 2):
        self.bucket = TokenBucket(rate, burst)
        self.queue = BoundedQueue(queue_cap)
        self.breaker = CircuitBreaker(slo, breach_window=breach_window,
                                      cooldown=cooldown, probes=probes)
        self.stats = AdmissionStats()

    def offer(self, req: Request, now: float) -> str:
        """Admit or shed one request; returns ``"admitted"`` or the shed
        reason (``"shed_breaker"`` | ``"shed_rate"`` | ``"shed_queue"``)."""
        self.stats.offered += 1
        if not self.breaker.allow(now):
            self.stats.shed_breaker += 1
            return "shed_breaker"
        if not self.bucket.admit(now):
            self.stats.shed_rate += 1
            return "shed_rate"
        if not self.queue.offer(req):
            self.stats.shed_queue += 1
            return "shed_queue"
        req.admitted_at = now
        self.stats.admitted += 1
        return "admitted"

    def next_request(self) -> Optional[Request]:
        """Oldest admitted request still waiting (None when empty)."""
        return self.queue.pop()

    def pending(self) -> int:
        """Admitted requests not yet handed to the scheduler."""
        return len(self.queue)

    def complete(self, req: Request, now: float) -> None:
        """Stamp a finished request and feed its latency to the breaker."""
        req.finished_at = now
        self.breaker.record(now, now - req.arrival)
