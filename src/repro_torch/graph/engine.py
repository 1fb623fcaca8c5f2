"""Device-resident iterative graph engine (reference: ``repro.graph.engine``).

The paper's headline workloads are iterative: PageRank amortizes one
``config`` over many ``reduce`` rounds.  The engine keeps all state on the
device and runs k rounds per :meth:`GraphEngine.run`, each round

    out = app.out_fn(state, extras)         # local SpMV (CSR CUDA kernel)
    in  = planned.reduce_on_device(out)     # 2*depth stacked-mesh exchanges
    state = app.update_fn(state, in, extras, transport)

over the stacked ``[M, ...]`` node axis, with one host round-trip per
``run`` (the caller's read of the result).  Where the reference compiles
the k rounds into one ``lax.scan`` dispatch, the port captures them, on
a CUDA device, as one CUDA graph (:class:`_GraphRun`): the first ``run``
of each ``(k, collect)`` warms the round's launches up once
(``WARMUP_ROUNDS`` eager rounds on its inputs) and captures the k rounds
on a static copy of the state and on the caller's extras; every ``run``
copies its state in, replays the graph once and returns copies of the
final state and last product (a trajectory is handed over whole, and the
next such run captures again).  A capture that fails raises; nothing
falls back to eager launches.  The CPU has no graphs and runs the same k
rounds as a Python loop (:meth:`GraphEngine.eager_fn`, also the card's
comparison for tests).  ``report`` keeps the reference's keys, and
``graph_launches`` counts the replays.

``overlap=True`` is the reference's rotated schedule (k >= 2): round 1's
product and down half of the reduce before the loop, then for each
later round the previous round's up half and update with this round's
product and down half, and round k's up half and update after it.  On
one stream every round's launches are the same, in the same order, so
the results are the plain build's bit for bit; the per-round exchanges
stay ``2 * depth``.

Layouts.  The reference stacks ELL tables, which pad every partition to
the global max rows x max per-row nonzeros; the hash permutation balances
columns, not row degrees, so power-law hub rows inflate ``K`` and the
padding, not the edges, sets the memory and the SpMV's time.  The port
keeps that API (:func:`build_ell`, :func:`stack_ell`, :func:`ell_matvec`)
and adds its unpadded counterpart, which PageRank, HADI and spectral run
on: :func:`build_csr`, :func:`stack_csr` (one block-diagonal CSR over all
stacked rows, with the kernel's work split), :func:`csr_matvec` (one
vector per node, the CSR kernel) and :func:`csr_matvec_wide` (W values
per index, HADI's bitstrings; plain torch ops, as the reference's W > 1
product is a jnp gather-sum with no kernel).  Both
stack functions write each node's table straight into preallocated
device tensors, so the host never holds the whole stack.
"""
from __future__ import annotations

import dataclasses
import gc
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.api import SparseAllreduce
from repro_torch.core.netmodel import EC2_2013, Fabric
from repro_torch.core.transport import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.spmv_csr import csr_bins, spmv_csr
from repro_torch.kernels.spmv_ell import spmv_ell


# ---------------------------------------------------------------------------
# Vectorized ELL construction
# ---------------------------------------------------------------------------

def build_ell(rows: np.ndarray, cols: np.ndarray, weights: np.ndarray,
              n_rows: int, min_k: int = 1
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized ELL build: COO triplets -> padded ``[n_rows, K]`` tables.

    Returns ``(ell_cols int32, ell_wts float32)`` with ``K = max(row_count,
    min_k)``; empty slots are ``-1`` / ``0``.  Entries within a row keep
    their original (stable) edge order.
    """
    if n_rows == 0:
        return (np.full((0, min_k), -1, np.int32),
                np.zeros((0, min_k), np.float32))
    order = np.argsort(rows, kind="stable")
    r = rows[order]
    counts = np.bincount(r, minlength=n_rows)
    kmax = max(int(counts.max(initial=0)), min_k)
    starts = np.zeros(n_rows + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slots = np.arange(len(r), dtype=np.int64) - starts[r]
    ell_cols = np.full((n_rows, kmax), -1, np.int32)
    ell_wts = np.zeros((n_rows, kmax), np.float32)
    ell_cols[r, slots] = np.asarray(cols)[order]
    ell_wts[r, slots] = np.asarray(weights)[order]
    return ell_cols, ell_wts


def stack_ell(tables: Sequence[Tuple[np.ndarray, np.ndarray]], n_rows: int,
              kmax: Optional[int] = None, device=None,
              n_cols: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stack per-node ``build_ell`` outputs into ``[M, n_rows, K]`` tensors
    on ``device`` (K = global max; rows/K padded with ``-1`` / ``0``).

    The stack is preallocated on the device and each node's table is
    copied into its slice as soon as ``tables[i]`` yields it, so a lazy
    sequence (one that builds table i on access, as ``pagerank_state``
    passes) keeps one node's table at a time on the host.  Give ``kmax``
    with a lazy sequence; otherwise it is read off the tables.  With
    ``n_cols`` (the length of the per-node vector the tables multiply),
    a column ``>= n_cols`` raises ``ValueError``: the SpMV kernel reads
    every non-negative column unchecked.
    """
    device = resolve_device(device)
    m = len(tables)
    if kmax is None:
        kmax = max((tables[i][0].shape[1] for i in range(m)), default=1)
    kmax = max(kmax, 1)
    cols = torch.full((m, n_rows, kmax), -1, dtype=torch.int32, device=device)
    wts = torch.zeros((m, n_rows, kmax), dtype=torch.float32, device=device)
    for i in range(m):
        c, w = tables[i]
        if n_cols is not None and c.size and int(c.max()) >= n_cols:
            raise ValueError(f"stack_ell: node {i} has column {int(c.max())}"
                             f" >= n_cols {n_cols}")
        cols[i, : c.shape[0], : c.shape[1]] = torch.from_numpy(c)
        wts[i, : w.shape[0], : w.shape[1]] = torch.from_numpy(w)
    return cols, wts


def ell_matvec(cols: torch.Tensor, wts: torch.Tensor, x: torch.Tensor,
               use_kernel: bool = False) -> torch.Tensor:
    """``y[..., r] = sum_k wts[..., r, k] * x[..., cols[..., r, k]]`` with
    ``cols < 0`` padding, batched over the stacked nodes.

    ``x``: one vector per node ``[..., N]`` -- then the ELL SpMV kernel
    runs (``repro_torch.kernels.spmv_ell``; its plain version for CPU
    tensors) -- or ``[..., N, W]`` (plain torch gather-sum).
    ``use_kernel`` is kept only for signature parity with the reference:
    the port always takes the kernel for one vector per node.
    """
    if x.ndim == cols.ndim - 1:
        return spmv_ell(cols, wts, x)
    lead, r, k = cols.shape[:-2], cols.shape[-2], cols.shape[-1]
    b, w = int(np.prod(lead, dtype=np.int64)), x.shape[-1]
    safe = cols.reshape(b, r * k, 1).clamp(min=0).to(torch.int64)
    g = torch.gather(x.reshape(b, -1, w), 1, safe.expand(b, r * k, w))
    mw = (wts * (cols >= 0)).reshape(b, r * k, 1)
    return (mw * g).reshape(b, r, k, w).sum(2).reshape(lead + (r, w))


def build_csr(rows: np.ndarray, cols: np.ndarray, weights: np.ndarray,
              n_rows: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized CSR build, the counterpart of :func:`build_ell`: COO
    triplets -> ``(row_ptr int64 [n_rows + 1], cols int32 [nnz], wts
    float32 [nnz])``.  Entries within a row keep their original (stable)
    edge order, the order :func:`build_ell` gives them."""
    rows = np.asarray(rows, np.int64)
    if rows.size and (rows.min() < 0 or rows.max() >= n_rows):
        raise ValueError(f"build_csr: row ids must lie in [0, {n_rows})")
    order = np.argsort(rows, kind="stable")
    row_ptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n_rows), out=row_ptr[1:])
    return (row_ptr, np.asarray(cols)[order].astype(np.int32),
            np.asarray(weights)[order].astype(np.float32))


def stack_csr(tables: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
              n_rows: int, nnz: Optional[int] = None, device=None,
              n_cols: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """Stack per-node :func:`build_csr` outputs into one block-diagonal
    CSR over the ``[M * n_rows]`` stacked rows on ``device``, the
    counterpart of :func:`stack_ell`: returns ``(row_ptr, cols, wts,
    bins)``.  Row ``r`` belongs to node ``r // n_rows`` (a node with fewer
    rows gets empty ones); ``cols`` stay node-local, so the product reads x
    at ``node * N + col``.  ``row_ptr`` is int32, or int64 once nnz
    reaches 2**31; ``bins`` is the kernel's work split
    (:func:`repro_torch.kernels.spmv_csr.csr_bins`), computed here once.

    The nonzeros are preallocated on the device and each node's are
    copied as soon as ``tables[i]`` yields them, so a lazy sequence keeps
    one node's table at a time on the host; give ``nnz`` (the total) with
    a lazy sequence, otherwise it is read off the tables.  With ``n_cols``
    a column ``>= n_cols`` (or < 0) raises ``ValueError``: the kernel
    reads x unchecked."""
    device = resolve_device(device)
    m = len(tables)
    if nnz is None:
        nnz = sum(len(tables[i][1]) for i in range(m))
    cols = torch.empty(nnz, dtype=torch.int32, device=device)
    wts = torch.empty(nnz, dtype=torch.float32, device=device)
    row_ptr = np.zeros(m * n_rows + 1, np.int64)
    at = 0
    for i in range(m):
        rp, c, w = tables[i]
        k = len(c)
        if len(rp) - 1 > n_rows or int(rp[-1]) != k or len(w) != k:
            raise ValueError(f"stack_csr: node {i} has {len(rp) - 1} rows "
                             f"(> {n_rows}?) or row_ptr[-1] {int(rp[-1])} "
                             f"!= {k} nonzeros")
        if at + k > nnz:
            raise ValueError(f"stack_csr: more than nnz={nnz} nonzeros")
        if n_cols is not None and k and (int(c.max()) >= n_cols
                                         or int(c.min()) < 0):
            raise ValueError(f"stack_csr: node {i} has column "
                             f"{int(c.max())} >= n_cols {n_cols} or < 0")
        base = i * n_rows
        row_ptr[base + 1: base + len(rp)] = at + rp[1:]
        row_ptr[base + len(rp): base + n_rows + 1] = at + k
        cols[at: at + k] = torch.from_numpy(np.ascontiguousarray(c, np.int32))
        wts[at: at + k] = torch.from_numpy(
            np.ascontiguousarray(w, np.float32))
        at += k
    if at != nnz:
        raise ValueError(f"stack_csr: {at} nonzeros, expected {nnz}")
    bins = csr_bins(row_ptr, n_rows)
    rp_dtype = np.int64 if nnz >= 2**31 else np.int32
    return (torch.as_tensor(row_ptr.astype(rp_dtype), device=device), cols,
            wts, torch.as_tensor(bins, device=device))


def csr_matvec(row_ptr: torch.Tensor, cols: torch.Tensor, wts: torch.Tensor,
               x: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """``y[m, r] = sum_j wts[j] * x[m, cols[j]]`` over row ``m * n_rows +
    r`` of a :func:`stack_csr` CSR, x one vector per node ``[M, N]`` ->
    ``[M, n_rows]``: the CSR SpMV kernel (``repro_torch.kernels.spmv_csr.
    spmv_csr``; its plain version for CPU tensors), the counterpart of
    :func:`ell_matvec` with ``bins`` its work split."""
    return spmv_csr(row_ptr, cols, wts, x, bins)


def csr_matvec_wide(row_ptr: torch.Tensor, cols: torch.Tensor,
                    wts: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The width-W product on a :func:`stack_csr` CSR: ``y[m, r, :] =
    sum_j wts[j] * x[m, cols[j], :]`` over row ``m * n_rows + r``, x
    ``[M, N, W]`` -> ``[M, n_rows, W]``, the counterpart of
    :func:`ell_matvec` at W > 1.  Plain torch ops: each nonzero's row of x
    is gathered and weighted, then added into its row with ``index_add_``.
    On CUDA that adds with atomics in no fixed order.  It stays so for
    HADI, its one caller: HADI's sums are of 0/1 bits with weight 1,
    exact in any order, so its bits repeat (the planned reduce, whose
    sums are of general floats, adds in a fixed order instead); general
    floats here may differ in the last ulp from run to run.  Memory:
    ``nnz * W`` values of scratch."""
    m, n, w = x.shape
    r = row_ptr.shape[0] - 1
    n_rows = r // m if m else 0
    lens = (row_ptr[1:] - row_ptr[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(r, device=x.device), lens,
                                   output_size=cols.shape[0])
    src = (rows // max(n_rows, 1)) * n + cols.long()
    g = x.reshape(m * n, w).index_select(0, src)
    g.mul_(wts.to(x.dtype).unsqueeze(1))
    y = torch.zeros(r, w, dtype=x.dtype, device=x.device)
    return y.index_add_(0, rows, g).reshape(m, n_rows, w)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EngineApp:
    """Per-round behaviour of one iterative workload.

    ``out_fn(state, extras) -> out``: the round's outbound values ``[M,
    u_cap(,W)]`` from the stacked state (typically the local SpMV over ELL
    extras).  ``update_fn(state, in_raw, extras, transport) -> state``:
    folds the reduced values ``[M, uin_cap(,W)]`` back into the state;
    ``transport`` (the plan's ``StackedTransport``) stands where the
    reference passes its mesh axis name.  ``value_width``: trailing value
    width W (1 for scalar-per-index).
    """
    out_fn: Callable[[Any, Any], Any]
    update_fn: Callable[[Any, Any, Any, Any], Any]
    value_width: int = 1
    name: str = "app"


def to_device(tree, device):
    """Numpy arrays / tensors (in dicts, lists, tuples) onto ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return torch.as_tensor(tree, device=device)


def _tree_map(fn, tree):
    """``fn`` on every tensor of a dict / list / tuple tree (None kept)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _tree_tensors(tree) -> List[torch.Tensor]:
    """The tensors of a tree, in a fixed order."""
    out: List[torch.Tensor] = []
    _tree_map(out.append, tree)
    return out


def _signature(tree):
    """Structure, shapes and dtypes of a tree: what a captured graph's
    static inputs fix."""
    if isinstance(tree, dict):
        return tuple((k, _signature(tree[k])) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,) + tuple(_signature(v) for v in tree)
    return (tuple(tree.shape), str(tree.dtype))


class _GraphRun:
    """One ``(k, collect)`` program of a :class:`GraphEngine` on a CUDA
    device: the k rounds captured once as a CUDA graph, replayed once per
    call.

    A capture clones ``state`` into a static buffer and reads ``extras``
    where the caller holds them (iteration-invariant inputs: the graph
    keeps them alive and reads them in place); it runs ``WARMUP_ROUNDS``
    eager rounds first on a side stream (every launch a round makes,
    before capture), then captures ``eager(static_state, extras)``.  A
    call captures anew when its state changes shape or dtype or its
    extras are other tensors; every call copies its state into the
    static buffer, replays, and returns clones of the final state and
    last product, which the next replay cannot overwrite.  A trajectory
    is not cloned: the run hands the graph's own outputs to the caller
    and drops the graph, and the next call captures again.

    The kernel wrappers count their launches in ``kernels._build.LAUNCHES``
    as they enqueue them, at capture too; a replay calls no wrapper, so
    the kernels a replay runs are counted by a trace of the device
    (``launches`` holds what the capture enqueued, one replay's worth).
    The transport's exchange and sum counts are the engine's accounting
    of rounds: a capture adds nothing to them and each replay adds what
    the capture issued."""

    def __init__(self, engine: "GraphEngine", eager: Callable,
                 collect: str):
        self.engine, self.eager, self.collect = engine, eager, collect
        self.graph = self.sig = None
        self.static_state = self.extras = self.static_out = None
        self.launches: Dict[str, int] = {}
        self.exchanges = (0, 0)

    def _capture(self, state, extras):
        dev, tr = self.engine.device, self.engine.transport
        self.graph = self.static_state = self.extras = self.static_out = None
        s_state = _tree_map(lambda t: t.clone(), state)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            warm = self.engine.eager_fn(GraphEngine.WARMUP_ROUNDS)(s_state,
                                                                   extras)
        torch.cuda.current_stream(dev).wait_stream(side)
        del warm
        launches, calls, sums = dict(_build.LAUNCHES), tr.calls, tr.sums
        graph = torch.cuda.CUDAGraph()
        # no cyclic collection inside the capture: an engine dropped
        # earlier is a cycle (it and its runner) holding its graph, and
        # freeing that graph is a CUDA call a capture forbids
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                s_out = self.eager(s_state, extras)
        finally:
            if collecting:
                gc.enable()
        self.launches = {k: v - launches[k] for k, v in _build.LAUNCHES.items()
                         if v != launches[k]}
        # the exchanges ran nowhere yet: each replay counts them
        self.exchanges = (tr.calls - calls, tr.sums - sums)
        tr.calls, tr.sums = calls, sums
        self.graph, self.static_state, self.extras = graph, s_state, extras
        self.static_out = s_out
        self.engine.report["captures"] += 1

    def __call__(self, state, extras):
        sig = (_signature(state), _signature(extras),
               tuple(t.data_ptr() for t in _tree_tensors(extras)))
        if self.graph is None or sig != self.sig:
            self._capture(state, extras)
            self.sig = sig
        for dst, src in zip(_tree_tensors(self.static_state),
                            _tree_tensors(state)):
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)
        self.graph.replay()
        tr = self.engine.transport
        tr.calls += self.exchanges[0]
        tr.sums += self.exchanges[1]
        self.engine.report["graph_launches"] += 1
        if self.collect == "trajectory":
            out = self.static_out
            self.graph = self.sig = None
            self.static_state = self.extras = self.static_out = None
            return out
        final, last_out, traj = self.static_out
        return (_tree_map(lambda t: t.clone(), final),
                _tree_map(lambda t: t.clone(), last_out), traj)


class GraphEngine:
    """k iterations on device per ``run`` (see module docstring).

    Construction runs the paper's ``config`` once (host numpy) and freezes
    the plan on ``device`` (default: the current CUDA device, raising
    without one).  ``report`` (also :meth:`sync_report`) keeps the
    reference's amortization counters: ``dispatches`` grows by one per
    ``run``, ``rounds`` by k, and ``step_traces`` by one each time a
    k-round callable is built (cached per ``(k, collect)``, as the
    reference caches its traced scan).

    ``degrees="auto"`` resolves through the autotuner's plan cache, and
    the ``config`` underneath is served from the memo, the disk cache or
    a fresh replan (``config_cache``, also in :meth:`sync_report`);
    ``plan_cache`` / ``retune`` forward to ``SparseAllreduce``.
    ``nodes`` names the pool positions of the M stacked nodes (default
    ``range(M)``); :meth:`remesh` rebinds the same program to others.
    ``overlap=True`` runs k >= 2 rounds in the rotated schedule (module
    docstring).  On a CUDA device every ``run`` is one graph replay
    (``report["graph_launches"]``; ``captures`` counts the captures).
    Spans (:mod:`repro_torch.obs`): ``engine.config`` the ``config``,
    ``engine.run`` each ``run``.
    """

    # eager rounds a capture runs first, on the static inputs
    WARMUP_ROUNDS = 1

    def __init__(self, out_sets, in_sets, app: EngineApp, *,
                 degrees="auto", device=None, seed: int = 0,
                 fabric: Fabric = EC2_2013, plan_cache=True,
                 retune: bool = False, overlap: bool = False,
                 nodes: Optional[Sequence[int]] = None):
        self.app = app
        self.overlap = bool(overlap)
        self.num_nodes = len(out_sets)
        self.out_sets = [np.asarray(o, np.uint32) for o in out_sets]
        self.in_sets = [np.asarray(i, np.uint32) for i in in_sets]
        self.seed = seed
        self.fabric = fabric
        self.plan_cache_arg = plan_cache
        self.ar = SparseAllreduce(self.num_nodes, degrees, backend="device",
                                  device=device, seed=seed, fabric=fabric,
                                  value_width=app.value_width,
                                  plan_cache=plan_cache, retune=retune,
                                  nodes=nodes)
        self.nodes = self.ar.nodes
        with obs.span("engine.config"):
            self.config_stats = self.ar.config(self.out_sets, self.in_sets)
        self.config_cache = self.ar.config_cache
        self.planned, self.device = self.ar.planned_parts()
        meta = self.ar.staging_metadata()
        self.u_cap: int = meta["u_cap"]
        self.uin_cap: int = meta["uin_cap"]
        self.out_lens = meta["out_lens"]
        self.in_lens = meta["in_lens"]
        self._routing = self.planned.device_args(self.device)
        self._run_cache: Dict[Tuple[int, str], Callable] = {}
        self.report = {"dispatches": 0, "rounds": 0, "step_traces": 0,
                       "graph_launches": 0, "captures": 0}

    def remesh(self, nodes: Sequence[int]) -> "GraphEngine":
        """The same engine program on other pool positions ``nodes`` (M of
        them): the recovery move when a position dies and spares exist
        (``repro_torch.resilience.engine``).  Partition, index pattern,
        *resolved* degrees and seed carry over, so the routing and every
        reduce result equal this engine's; on one card the stacked
        computation is the same tensor program, so the bits are equal by
        construction.  Configs are memo-keyed on the positions, so a
        remap back to positions used before is a memo hit."""
        return GraphEngine(self.out_sets, self.in_sets, self.app,
                           degrees=self.ar.plan.degrees, device=self.device,
                           seed=self.seed, fabric=self.fabric,
                           plan_cache=self.plan_cache_arg, retune=False,
                           overlap=self.overlap, nodes=nodes)

    @property
    def transport(self):
        """The stacked-mesh transport every round's reduce runs on."""
        return self._routing.transport

    def sync_report(self) -> dict:
        """Per-round sync accounting: one reduce = ``depth`` down +
        ``depth`` up exchanges (the rotated schedule splits round 1's and
        round k's halves around the loop, with the same total); host
        round-trips equal ``run`` calls."""
        return dict(self.report,
                    butterfly_depth=self.planned.depth,
                    reduce_collectives_per_round=2 * self.planned.depth,
                    host_roundtrips=self.report["dispatches"],
                    config_cache=self.config_cache,
                    overlap=self.overlap)

    def eager_fn(self, k: int, collect: str = "last") -> Callable:
        """The k rounds of :meth:`run` as a Python loop of eager launches,
        ``run_k(state, extras) -> (final, last_out, traj)``, in the rotated
        schedule with ``overlap`` and k >= 2: what the CPU runs, and what
        a test or the smoke holds the card's graph replay against.  Not
        cached, not counted in ``report``."""
        if collect not in ("last", "trajectory"):
            raise ValueError(f"collect must be 'last' or 'trajectory', "
                             f"got {collect!r}")
        if k < 1:
            raise ValueError(f"need k >= 1 rounds, got {k}")
        planned, app, routing = self.planned, self.app, self._routing
        tr = routing.transport

        def record(traj, i, state):
            if collect != "trajectory":
                return None
            if isinstance(state, torch.Tensor):
                if traj is None:   # one [k, ...] buffer, filled in place
                    traj = state.new_empty((k,) + tuple(state.shape))
                traj[i].copy_(state)
                return traj
            return (traj or []) + [state]

        def run_k(state, extras):
            last_out, traj = None, None
            for i in range(k):
                last_out = app.out_fn(state, extras)
                in_raw = planned.reduce_on_device(last_out, routing)
                state = app.update_fn(state, in_raw, extras, tr)
                traj = record(traj, i, state)
            return state, last_out, traj

        def run_rotated(state, extras):
            # round 1's product and down half before the loop; each body
            # is round i's up half and update, then round i + 1's product
            # and down half; round k's up half and update after it
            traj = None
            last_out = app.out_fn(state, extras)
            bottom = planned.reduce_down_on_device(last_out, routing)
            for i in range(k - 1):
                in_raw = planned.reduce_up_on_device(bottom, routing)
                state = app.update_fn(state, in_raw, extras, tr)
                traj = record(traj, i, state)
                last_out = app.out_fn(state, extras)
                bottom = planned.reduce_down_on_device(last_out, routing)
            in_raw = planned.reduce_up_on_device(bottom, routing)
            state = app.update_fn(state, in_raw, extras, tr)
            traj = record(traj, k - 1, state)
            return state, last_out, traj

        return run_rotated if self.overlap and k >= 2 else run_k

    def run_fn(self, k: int, collect: str = "last") -> Callable:
        """The k-round callable ``run(state, extras) -> (final, last_out,
        traj)`` that :meth:`run` invokes, cached per ``(k, collect)``: on a
        CUDA device a :class:`_GraphRun` (one graph replay a call), on the
        CPU the eager loop."""
        fn = self._run_cache.get((k, collect))
        if fn is None:
            eager = self.eager_fn(k, collect)
            fn = _GraphRun(self, eager, collect) \
                if self.device.type == "cuda" else eager
            self._run_cache[(k, collect)] = fn
            self.report["step_traces"] += 1
        return fn

    @obs.span("engine.run")
    def run(self, k: int, state, extras=None, *, collect: str = "last"):
        """Execute k rounds on the device.

        ``state``: stacked ``[M, ...]`` tensor (or numpy array) per-node
        state, typically ``[M, uin_cap(,W)]``; ``extras``: iteration-
        invariant stacked inputs (e.g. the ELL tables).  Both are moved to
        the engine's device.  Returns ``(final_state, last_out, traj)``
        as device tensors: ``last_out`` is round k's pre-reduce outbound
        values ``[M, u_cap(,W)]``; ``traj`` stacks every round's state when
        ``collect="trajectory"``, else None.  On a CUDA device the k
        rounds are one graph replay.
        """
        fn = self.run_fn(k, collect)
        state = to_device(state, self.device)
        extras = to_device(extras if extras is not None else {}, self.device)
        out = fn(state, extras)
        self.report["dispatches"] += 1
        self.report["rounds"] += k
        return out
