"""The serving tier's sparse exchange: Zipf token statistics and MoE
expert load routed through ``SparseAllreduce`` (reference:
``repro.serve.dispatch``).

Three exchanges, all over the data positions of the serving mesh (one
logical allreduce node per position, the stacked transport of
``SparseAllreduce(backend="device")`` on one device):

  * **Hot set (frozen plan).**  Zipf head token ids are learned once
    from a warmup sample (:meth:`SparseServeDispatch.fit_hot_set`) and
    frozen into the paper's two-call ``config``/``reduce`` path: every
    decode step is a ``reduce`` of per-shard head-count vectors over the
    same plan -- config once, reduce many.
  * **Tail (union path, shape-bucketed).**  Per-step tail ids go through
    ``union_reduce`` -- the paper's dynamic mini-batch mode -- with both
    capacities rounded to power-of-two buckets
    (``repro_torch.core.allreduce.shape_bucket``), so the union path's
    plan cache is keyed by O(log) shapes and batch churn almost always
    hits (``union_plan_stats``).  ``merge=`` and ``wire=`` pass through:
    with ``merge="fused"`` or ``"banded"`` the tail union is where serving
    launches the merge-rank and scatter kernels (the scaled scatters
    under ``wire="delta+int8ef"``).
  * **Expert load (frozen plan).**  The expert-id space is static, so
    per-shard expert-load vectors reduce over a plan configured once at
    construction.  Assignments come from :func:`make_expert_predictor`
    -- the token's input embedding routed through a real router via
    ``repro_torch.models.moe.router_topk``, the routing decision the MoE
    block would make for that token at layer entry.

The dispatch only *observes* the token stream (its outputs feed metrics),
so enabling it cannot perturb generation; ``tests/test_torch_serve_tier.py``
asserts both that and the exchange's agreement with a numpy bincount.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

import torch

from repro_torch.core.allreduce import shape_bucket
from repro_torch.core.api import SparseAllreduce
from repro_torch.core.sparse_vec import SENTINEL


@dataclasses.dataclass
class StepExchange:
    """One step's combined statistics: global counts over the head set
    plus the union-reduced tail, and the union overflow (dropped tail
    entries when the bucketed out-capacity saturates)."""
    head_ids: np.ndarray        # [H] uint32
    head_counts: np.ndarray     # [H] float32, summed over shards
    tail_ids: np.ndarray        # [U] uint32, union over shards
    tail_counts: np.ndarray     # [U] float32
    overflow: int

    def count_of(self, token_id: int) -> float:
        """Global observed count of one token id this step."""
        hit = np.nonzero(self.head_ids == np.uint32(token_id))[0]
        if len(hit):
            return float(self.head_counts[hit[0]])
        hit = np.nonzero(self.tail_ids == np.uint32(token_id))[0]
        return float(self.tail_counts[hit[0]]) if len(hit) else 0.0


class SparseServeDispatch:
    """Per-step sparse exchange over ``num_shards`` serving data shards,
    stacked on ``device`` (default: the current CUDA device, as
    ``SparseAllreduce``'s).  ``wire`` and ``merge`` apply to the dynamic
    tail union; the frozen head / expert plans stay ``raw`` (the planned
    path is the bit-exact baseline the harness checks against)."""

    def __init__(self, num_shards: int, *, vocab: int, n_experts: int = 0,
                 degrees=None, merge: str = "sort", wire: str = "raw",
                 device=None, seed: int = 1234, union_floor: int = 8):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.num_shards = num_shards
        self.vocab = int(vocab)
        self.n_experts = int(n_experts)
        self.union_floor = int(union_floor)
        if degrees is None:
            degrees = (num_shards,) if num_shards > 1 else ()
        kw = dict(backend="device", merge=merge, device=device, seed=seed)
        self._head_ar = SparseAllreduce(num_shards, degrees, wire="raw", **kw)
        self._tail_ar = SparseAllreduce(num_shards, degrees, wire=wire, **kw)
        self._moe_ar = None
        if self.n_experts:
            self._moe_ar = SparseAllreduce(num_shards, degrees, wire="raw",
                                           **kw)
            eids = np.arange(self.n_experts, dtype=np.uint32)
            self._moe_ar.config([eids] * num_shards, [eids] * num_shards)
        self.head_ids: Optional[np.ndarray] = None
        self._head_lookup: Optional[dict] = None
        self.frozen_reduces = 0      # reduce() calls over frozen plans
        self.steps = 0
        self.last: Optional[StepExchange] = None

    # ------------------------------------------------------------------
    def fit_hot_set(self, sample_ids: np.ndarray, head_size: int = 64
                    ) -> np.ndarray:
        """Learn the Zipf head from a warmup sample and freeze its plan.

        ``head_size`` is bucketed (power of two) and clipped to the
        vocab; the head is the top-``H`` ids by sample frequency, ties
        broken by id.  Returns the head ids.  Must be called before
        :meth:`on_step`."""
        sample = np.asarray(sample_ids, np.int64).reshape(-1)
        h = min(shape_bucket(head_size, self.union_floor), self.vocab)
        counts = np.bincount(sample, minlength=self.vocab)[:self.vocab]
        order = np.lexsort((np.arange(self.vocab), -counts))
        self.head_ids = order[:h].astype(np.uint32)
        self._head_lookup = {int(t): i for i, t in enumerate(self.head_ids)}
        ids = [self.head_ids] * self.num_shards
        self._head_ar.config(ids, ids)
        return self.head_ids

    # ------------------------------------------------------------------
    def on_step(self, tok_shards: Sequence[np.ndarray]) -> StepExchange:
        """Exchange one decode step's active token ids.

        ``tok_shards``: one int array per data shard (the shard's active
        slots' current input ids; may be empty).  Returns the global
        :class:`StepExchange`; every shard would see the same result —
        the union butterfly is a gather-all."""
        if self.head_ids is None:
            raise RuntimeError("fit_hot_set() must run before on_step()")
        if len(tok_shards) != self.num_shards:
            raise ValueError(
                f"expected {self.num_shards} shard token lists, got "
                f"{len(tok_shards)}")
        h = len(self.head_ids)
        head_vals = []
        tails = []
        for toks in tok_shards:
            toks = np.asarray(toks, np.int64).reshape(-1)
            hv = np.zeros(h, np.float32)
            tail_list = []
            for t in toks:
                j = self._head_lookup.get(int(t))
                if j is None:
                    tail_list.append(int(t))
                else:
                    hv[j] += 1.0
            head_vals.append(hv)
            u, c = np.unique(np.asarray(tail_list, np.int64),
                             return_counts=True)
            tails.append((u.astype(np.uint32), c.astype(np.float32)))

        head_out = self._head_ar.reduce(head_vals)[0].astype(np.float32)
        self.frozen_reduces += 1
        tail_ids, tail_counts, ovf = self._union_tail(tails)
        self.steps += 1
        self.last = StepExchange(
            head_ids=self.head_ids, head_counts=head_out,
            tail_ids=tail_ids, tail_counts=tail_counts, overflow=ovf)
        return self.last

    def _union_tail(self, tails):
        """Union-reduce per-shard (ids, counts) through the bucketed
        dynamic path; returns (ids, counts, overflow)."""
        m = self.num_shards
        longest = max((len(u) for u, _ in tails), default=0)
        cap = shape_bucket(longest, self.union_floor)
        out_cap = shape_bucket(min(self.vocab, cap * m), self.union_floor)
        idx = np.full((m, cap), SENTINEL, np.uint32)
        val = np.zeros((m, cap), np.float32)
        perm = self._tail_ar.perm
        for n, (u, c) in enumerate(tails):
            if not len(u):
                continue
            hashed = perm.fwd_np(u)
            order = np.argsort(hashed)
            idx[n, :len(u)] = hashed[order]
            val[n, :len(u)] = c[order]
        oi, ov, ovf = self._tail_ar.union_reduce(idx, val, out_cap)
        oi, ov = oi[0].cpu().numpy(), ov[0].cpu().numpy()
        ok = oi != SENTINEL
        ids = perm.inv_np(oi[ok].astype(np.uint32))
        return ids, ov[ok].astype(np.float32), int(ovf[0])

    # ------------------------------------------------------------------
    def expert_load(self, ek_shards: Sequence[np.ndarray]) -> np.ndarray:
        """Combine per-shard expert assignments into the global per-expert
        load via the frozen expert plan.

        ``ek_shards``: one int array or tensor of expert ids per shard
        (any shape — typically the ``[N, K]`` output of the predictor, on
        its device).  Returns
        float32 ``[n_experts]`` global assignment counts."""
        if self._moe_ar is None:
            raise RuntimeError(
                "expert_load requires n_experts > 0 at construction")
        vals = []
        for ek in ek_shards:
            if isinstance(ek, torch.Tensor):
                ek = ek.cpu().numpy()
            ek = np.asarray(ek, np.int64).reshape(-1)
            vals.append(np.bincount(ek, minlength=self.n_experts)
                        [:self.n_experts].astype(np.float32))
        out = self._moe_ar.reduce(vals)[0].astype(np.float32)
        self.frozen_reduces += 1
        return out

    # ------------------------------------------------------------------
    @property
    def plan_resolutions(self) -> int:
        """Total plan lookups: frozen reduces + union-path resolutions."""
        u = self._tail_ar.union_plan_stats
        return self.frozen_reduces + u["hits"] + u["misses"]

    @property
    def plan_hit_rate(self) -> float:
        """Fraction of plan resolutions served without planning
        again: frozen-plan reduces (the plan was configured once) and
        union-cache hits, over all resolutions."""
        u = self._tail_ar.union_plan_stats
        total = self.plan_resolutions
        return (self.frozen_reduces + u["hits"]) / total if total else 1.0


def make_expert_predictor(cfg):
    """Shadow router: ``fn(emb, router, ids) -> ek [N, K]``.

    Routes each token's *input embedding* through a router matrix using
    the shared :func:`repro_torch.models.moe.router_topk` -- the same
    masked softmax / top-k / renormalise the MoE block applies -- so the
    serving tier's expert-load signal counts the experts the model would
    engage for those tokens at layer entry.  ``emb``: ``[V_pad, d]``;
    ``router``: ``[d, E_pad]`` (e.g. the first MoE block's, period 0)."""
    from repro_torch.models.moe import router_topk

    @torch.no_grad()
    def fn(emb, router, ids):
        ids = torch.as_tensor(np.asarray(ids) if not isinstance(
            ids, torch.Tensor) else ids, device=emb.device).to(torch.int64)
        x = emb[ids].to(torch.float32)
        _, _, ek = router_topk(x @ router.to(torch.float32), cfg)
        return ek

    return fn


def first_moe_router(params) -> Optional[torch.Tensor]:
    """The first MoE block's period-0 router matrix from a param tree
    (``blocks.b*.moe.router`` is ``[n_periods, d, E_pad]``), or None for
    dense archs."""
    blocks = params.get("blocks", {})
    for key in sorted(blocks):
        if isinstance(blocks[key], dict) and "moe" in blocks[key]:
            return blocks[key]["moe"]["router"][0]
    return None
