"""Supervised graph-engine runs: faults and checkpoints around ``GraphEngine`` (reference: ``repro.resilience.engine``).

:class:`SupervisedEngineLoop` chops an iterative run (PageRank, HADI,
spectral) into blocks and, between blocks, makes the supervisor's three
moves:

1. **Consult the fault schedule** over a pool of node positions larger
   than the engine's M (an M-partition job on an N-position fleet,
   N >= M).  Dead positions that host no partition change nothing.
2. **Remap on loss** -- when a position hosting a partition dies but at
   least M positions survive, :meth:`repro_torch.graph.engine.
   GraphEngine.remesh` rebinds the identical program to the first M
   alive ones.  Partition, resolved degrees and seed are unchanged, so
   the continued run equals an uninterrupted one bit for bit; on one
   card the stacked computation does not depend on the positions at all.
3. **Checkpoint and exact resume** -- after every block the state is
   saved through the atomic :func:`repro_torch.checkpoint.store.save` at
   full float32 precision; :meth:`run` takes ``start_round`` to continue
   a reloaded state.  The block length is ``ckpt_every``, so a resumed run
   repeats the baseline's block structure.

Without spare positions the loop degrades per ``repartition`` (a caller
callback building a smaller job) or fails fast with :class:`QuorumLost`.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Set, Tuple

from repro_torch.checkpoint import store
from repro_torch.core.faults import FailureSchedule
from repro_torch.core.netmodel import EC2_2013, Fabric
from repro_torch.graph.engine import EngineApp, GraphEngine
from .events import GROUP_LOST, REPLICA_ABSORBED, FaultEvent, QuorumLost
from .supervisor import pool_positions


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return store.to_numpy(tree)


class SupervisedEngineLoop:
    """Blocked, supervised, checkpointed ``GraphEngine`` run (module
    docstring).

    ``pool``: the fleet's node positions, a count or a list (default
    ``range(M)``, no spares); the engine runs on the first
    ``M = len(out_sets)`` of them and remaps within the pool.
    ``schedule.dead_at(round)`` (from round ``fault_at`` on) gives the
    dead pool indices.  ``ckpt_every`` is both the checkpoint interval and
    the block length: keep it fixed between a baseline and a faulted or
    resumed run to compare them bit for bit.  ``on_block(round, state)``
    runs after each block (the soak harness's kill hook).  ``device``
    binds the engine (default: the current CUDA device).
    """

    def __init__(self, out_sets, in_sets, app: EngineApp, *,
                 degrees="auto", seed: int = 0, fabric: Fabric = EC2_2013,
                 schedule: Optional[FailureSchedule] = None,
                 fault_at: int = 0,
                 repartition: Optional[Callable] = None,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                 plan_cache=True, pool=None, device=None,
                 on_block: Optional[Callable] = None):
        m = len(out_sets)
        self.pool = pool_positions(pool, m)
        self.schedule = schedule
        self.fault_at = fault_at
        self.repartition = repartition
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.on_block = on_block
        self.assignment = list(range(m))   # partition -> pool index
        self._dead: Set[int] = set()
        self.events: List[FaultEvent] = []
        self.remaps = 0
        self.engine = GraphEngine(
            out_sets, in_sets, app, degrees=degrees, device=device,
            seed=seed, fabric=fabric, plan_cache=plan_cache,
            nodes=self._nodes())

    def _nodes(self) -> List[int]:
        return [self.pool[p] for p in self.assignment]

    # ------------------------------------------------------------------
    def _supervise(self, rnd: int) -> None:
        """Apply the dead set active at round ``rnd`` (remap or raise)."""
        if self.schedule is None or rnd < self.fault_at:
            return
        dead = set(self.schedule.dead_at(rnd))
        if dead == self._dead:
            return
        self._dead = dead
        m = len(self.assignment)
        hit = [i for i, p in enumerate(self.assignment) if p in dead]
        alive = [p for p in range(len(self.pool)) if p not in dead]
        if not hit:
            # spares died; the engine's positions are untouched
            self.events.append(FaultEvent(
                step=rnd, attempt=0, dead=frozenset(dead),
                klass=REPLICA_ABSORBED, lost=(),
                survivors=tuple(range(m))))
            return
        if len(alive) >= m:
            self.assignment = alive[:m]
            self.engine = self.engine.remesh(self._nodes())
            self.remaps += 1
            self.events.append(FaultEvent(
                step=rnd, attempt=0, dead=frozenset(dead),
                klass=GROUP_LOST, lost=tuple(hit),
                survivors=tuple(range(m))))
            return
        if self.repartition is not None:
            self.engine, self.assignment = self.repartition(self, alive)
            self.remaps += 1
            self.events.append(FaultEvent(
                step=rnd, attempt=0, dead=frozenset(dead),
                klass=GROUP_LOST, lost=tuple(hit),
                survivors=tuple(range(len(self.assignment)))))
            return
        raise QuorumLost(
            f"round {rnd}: {len(alive)} alive pool positions cannot host "
            f"{m} partitions and no repartition callback is set "
            f"(dead={sorted(dead)})")

    # ------------------------------------------------------------------
    def run(self, rounds: int, state, extras=None, *,
            start_round: int = 0) -> Tuple[Any, Any]:
        """Run ``rounds`` total rounds, continuing at ``start_round`` (0
        for a fresh run; a resumed caller passes the checkpointed round).
        Returns ``(final_state, last_out)``; the state after each block
        lands in ``ckpt_dir`` as ``ckpt-<round>``."""
        block = self.ckpt_every if self.ckpt_every > 0 else rounds
        rnd = start_round
        last_out = None
        while rnd < rounds:
            self._supervise(rnd)
            k = min(block, rounds - rnd)
            state, last_out, _ = self.engine.run(k, state, extras)
            rnd += k
            if self.ckpt_dir:
                store.save(f"{self.ckpt_dir}/ckpt-{rnd}",
                           {"state": _to_numpy(state)},
                           meta={"round": rnd,
                                 "events": [e.klass for e in self.events]})
            if self.on_block is not None:
                self.on_block(rnd, state)
        return state, last_out
