"""Slot-based continuous batching over the fused greedy decode steps (reference: ``repro.serve.scheduler``).

A fixed number of batch ``slots`` is decoded together (one decode shape
for the scheduler's life: the same kernels, and on the card the same
cuBLAS algorithms, every step); requests join a free slot via a
per-request prefill and leave on EOS / ``max_new`` (evict-on-EOS), so
decode never waits for the longest request in a batch -- on top of
``repro_torch.train.step.make_prefill_greedy_step`` /
``make_decode_greedy_step``.

Correctness (``tests/test_torch_serve_tier.py``, and ``chip_smoke.py``'s
serve phases on the card): a request's decode rows do not depend on what
the other slots hold -- attention masks by position, a prefill
overwrites a slot's whole cache and state slice, and per-row compute
never sums across the batch: the cache writes are one slot a row, and no
scatter on the prefill or decode path accumulates (the MoE's dispatch
and combine write distinct slots; their one ``index_add_``, an
``index_select`` backward, never runs without a gradient).  So
continuous batching returns token for token the ids the sequential
one-request-at-a-time oracle (``service.run_sequential_oracle``) returns
through the same slot geometry.

The MoE bound: free slots decode garbage rows (token 0 at position 0),
and those rows route like live ones, so the MoE must drop no copy at
decode, or a garbage row could take a live row's capacity.  Each data
position decodes ``slots / M`` rows (at tp > 1 padded to a multiple of
tp, the padding routed too); a token's top-k experts are distinct, so an
expert receives at most one copy of each row, and ``moe.capacities``
floors both capacities at 8.  The scheduler checks the exact condition
(:func:`moe_decode_drops_nothing`: a position's copies to one device fit
``cap_dev``, an expert's copies fit ``cap_e``; with at most 8 rows a
position, and at tp <= 2 with the default capacity factor, it always
holds) and refuses a geometry that breaks it.

Join prefill tiles the prompt to M rows (one a data position) and writes
row 0 into the slot along the batch dim, dim 1 of every cache leaf: a
slice copy on the device.  Host <-> device traffic per decode step is
the slots' int32 ids and positions in and their int32 ids out -- never
the vocab-sized logits.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.train.step import (MeshCtx, init_cache_global,
                                    make_decode_greedy_step,
                                    make_prefill_greedy_step)

from .queue import Request


@dataclasses.dataclass
class SchedulerMetrics:
    """Counters the service reports from."""
    decode_steps: int = 0
    joins: int = 0
    evictions: int = 0
    tokens_out: int = 0


def moe_decode_drops_nothing(cfg: ModelConfig, rows: int, tp: int) -> bool:
    """Whether an MoE decode of ``rows`` rows a data position drops no
    copy: a model position's n = ceil(rows / tp) tokens send at most n *
    min(top_k, experts_local) copies to one device (``cap_dev``) and an
    expert receives at most tp * n (``cap_e``)."""
    if not cfg.n_experts:
        return True
    n = -(-rows // tp)
    cap_dev, cap_e = MOE.capacities(cfg, n, tp, cfg.moe_capacity)
    return (n * min(cfg.top_k, cfg.experts_local(tp)) <= cap_dev
            and tp * n <= cap_e)


def _write_slot(cache, pcache, slot: int) -> None:
    """Row 0 of the prefill cache into batch row ``slot`` of every leaf
    (the batch dim is 1 on every leaf: [n_periods, B, ...]), in place."""
    for (_, c), (_, n) in zip(T.cache_leaves(cache), T.cache_leaves(pcache)):
        c[:, slot].copy_(n[:, 0])


class ContinuousBatchingScheduler:
    """Continuous-batching decode over ``slots`` batch rows on the mesh
    ``mesh`` (a ``train.step.MeshCtx``).

    Decoder-only configs (no encoder / image prefix): the serving tier
    batches requests with nothing in common, so there is no shared
    cross-cache to carry.  ``slots`` must be a multiple of the mesh's M
    data positions (batch rows shard contiguously over them), and with an
    MoE small enough that a decode drops nothing (module docstring).

    ``dispatch`` (optional, :class:`repro_torch.serve.dispatch.
    SparseServeDispatch`) is fed the active slots' current token ids --
    grouped by owning data position -- every ``dispatch_every`` decode
    steps; it only observes the token stream, it never perturbs it.
    """

    def __init__(self, cfg: ModelConfig, mesh: MeshCtx, params, *,
                 slots: int, max_seq: int, dispatch=None,
                 dispatch_every: int = 1):
        if cfg.enc_layers or cfg.img_tokens:
            raise ValueError(
                "continuous batching serves decoder-only configs; "
                "encoder/vision archs use the fixed-batch path "
                "(repro_torch.launch.serve)")
        mc = mesh
        if slots < 1 or slots % mc.dp:
            raise ValueError(
                f"slots={slots} must be a positive multiple of the data "
                f"axis size dp={mc.dp} (batch rows shard over data)")
        if not moe_decode_drops_nothing(cfg, slots // mc.dp, mc.tp):
            raise ValueError(
                f"slots={slots} over dp={mc.dp} at tp={mc.tp}: an MoE "
                f"decode of {slots // mc.dp} rows a position could drop a "
                f"copy, and a free slot's row take a live row's capacity")
        if dispatch is not None and dispatch.num_shards != mc.dp:
            raise ValueError(
                f"dispatch has {dispatch.num_shards} shards, mesh has "
                f"dp={mc.dp}")
        self.cfg = cfg
        self.mesh = mesh
        self.params = params
        self.slots = slots
        self.max_seq = max_seq
        self.dispatch = dispatch
        self.dispatch_every = max(1, int(dispatch_every))
        self.metrics = SchedulerMetrics()
        self._mc = mc
        self._prefill, _ = make_prefill_greedy_step(cfg, mc, max_seq)
        self._decode, _ = make_decode_greedy_step(cfg, mc)
        self._cache = init_cache_global(cfg, mc, slots, max_seq)
        self._tok = np.zeros(slots, np.int32)
        self._pos = np.zeros(slots, np.int32)
        self._reqs: List[Optional[Request]] = [None] * slots
        self._completed: List[Request] = []

    # ------------------------------------------------------------------
    @property
    def active(self) -> int:
        """Occupied slot count."""
        return sum(r is not None for r in self._reqs)

    def free_slots(self) -> List[int]:
        """Indices of currently free slots (ascending)."""
        return [s for s, r in enumerate(self._reqs) if r is None]

    def pop_completed(self) -> List[Request]:
        """Drain requests finished since the last call (join or step)."""
        out, self._completed = self._completed, []
        return out

    def reset(self) -> None:
        """Clear all slots and counters, keeping the steps and the cache.

        Stale cache contents are harmless by construction -- prefill
        overwrites a joining slot's entire cache/state slice and decode
        attends only positions this request wrote -- which is what the
        consistency harness relies on when it reuses one scheduler for the
        batched run and the sequential oracle."""
        self._tok[:] = 0
        self._pos[:] = 0
        self._reqs = [None] * self.slots
        self._completed = []
        self.metrics = SchedulerMetrics()

    # ------------------------------------------------------------------
    def join(self, req: Request) -> int:
        """Prefill ``req`` into the lowest free slot; returns the slot.

        The prompt is tiled to M rows (one a data position) and row 0 of
        the resulting cache is written into the slot.  The prefill's
        greedy next token is the request's first generated id; a
        ``max_new=1`` request completes here without ever entering the
        decode batch."""
        free = self.free_slots()
        if not free:
            raise RuntimeError("join() with no free slot")
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        if len(prompt) + req.max_new > self.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt {len(prompt)} + max_new "
                f"{req.max_new} exceeds max_seq {self.max_seq}")
        slot = free[0]
        toks = np.tile(prompt[None], (self._mc.dp, 1))
        ids, pcache = self._prefill(self.params, {"tokens": toks})
        _write_slot(self._cache, pcache, slot)
        del pcache
        first = int(ids[0].cpu())
        req.tokens.append(first)
        self.metrics.joins += 1
        self.metrics.tokens_out += 1
        if req.done():
            self._evict_into_completed(req, slot, occupied=False)
        else:
            self._reqs[slot] = req
            self._tok[slot] = first
            self._pos[slot] = len(prompt)
        return slot

    def step(self) -> None:
        """One fused decode step over all slots (no-op when idle).

        Each active slot consumes its pending token at its position and
        produces the next greedy id; free slots decode garbage rows whose
        results are discarded (row independence makes them harmless, and
        their positions are pinned at 0).  Completions are queued for
        :meth:`pop_completed`."""
        if self.active == 0:
            return
        if self.dispatch is not None \
                and self.metrics.decode_steps % self.dispatch_every == 0:
            self.dispatch.on_step(self._active_tokens_by_shard())
        ids, self._cache = self._decode(self.params, self._tok, self._pos,
                                        self._cache)
        ids = ids.cpu().numpy()
        self.metrics.decode_steps += 1
        for slot, req in enumerate(self._reqs):
            if req is None:
                continue
            tok = int(ids[slot])
            req.tokens.append(tok)
            self.metrics.tokens_out += 1
            if req.done():
                self._evict_into_completed(req, slot, occupied=True)
            else:
                self._tok[slot] = tok
                self._pos[slot] += 1

    def _evict_into_completed(self, req: Request, slot: int,
                              occupied: bool) -> None:
        if occupied:
            self._reqs[slot] = None
            self.metrics.evictions += 1
        self._tok[slot] = 0
        self._pos[slot] = 0
        self._completed.append(req)

    def _active_tokens_by_shard(self) -> List[np.ndarray]:
        """Current input ids of active slots, grouped by the data position
        that owns each contiguous slot block."""
        per = self.slots // self._mc.dp
        out = []
        for n in range(self._mc.dp):
            sl = [self._tok[s] for s in range(n * per, (n + 1) * per)
                  if self._reqs[s] is not None]
            out.append(np.asarray(sl, np.int32))
        return out
