"""Device-resident iterative graph engine (reference: ``repro.graph.engine``).

The paper's headline workloads are iterative: PageRank amortizes one
``config`` over many ``reduce`` rounds.  The engine keeps all state on the
device and runs k rounds per :meth:`GraphEngine.run`, each round

    out = app.out_fn(state, extras)         # local SpMV (CSR CUDA kernel)
    in  = planned.reduce_on_device(out)     # 2*depth stacked-mesh exchanges
    state = app.update_fn(state, in, extras, transport)

over the stacked ``[M, ...]`` node axis, with one host round-trip per
``run`` (the caller's read of the result).  Where the reference compiles
the k rounds into one ``lax.scan`` dispatch, ``run(k)`` here is a Python
loop of k rounds of eager launches; capturing it as one CUDA graph is a
later PR.  ``report`` keeps the reference's keys.

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
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.api import SparseAllreduce
from repro_torch.core.netmodel import EC2_2013, Fabric
from repro_torch.core.transport import resolve_device
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
    is gathered and weighted, then added into its row with ``index_add_``
    (atomics on CUDA, so sums are exact in any order only for values like
    HADI's 0/1 bits; general floats may differ in the last ulp from run
    to run).  Memory: ``nnz * W`` values of scratch."""
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


class GraphEngine:
    """k iterations on device per ``run`` (see module docstring).

    Construction runs the paper's ``config`` once (host numpy) and freezes
    the plan on ``device`` (default: the current CUDA device, raising
    without one).  ``report`` (also :meth:`sync_report`) keeps the
    reference's amortization counters: ``dispatches`` grows by one per
    ``run``, ``rounds`` by k, and ``step_traces`` by one each time a
    k-round callable is built (cached per ``(k, collect)``, as the
    reference caches its traced scan).  ``overlap=True``, the persistent
    plan cache and ``retune`` are not ported yet and raise.
    """

    def __init__(self, out_sets, in_sets, app: EngineApp, *,
                 degrees="auto", device=None, seed: int = 0,
                 fabric: Fabric = EC2_2013, plan_cache: bool = False,
                 retune: bool = False, overlap: bool = False):
        if overlap:
            raise NotImplementedError(
                "GraphEngine(overlap=True) is not ported yet (ROADMAP "
                "Queue 1 item 12)")
        self.app = app
        self.overlap = False
        self.num_nodes = len(out_sets)
        self.out_sets = [np.asarray(o, np.uint32) for o in out_sets]
        self.in_sets = [np.asarray(i, np.uint32) for i in in_sets]
        self.seed = seed
        self.fabric = fabric
        self.ar = SparseAllreduce(self.num_nodes, degrees, backend="device",
                                  device=device, seed=seed, fabric=fabric,
                                  value_width=app.value_width,
                                  plan_cache=plan_cache, retune=retune)
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
        self.report = {"dispatches": 0, "rounds": 0, "step_traces": 0}

    @property
    def transport(self):
        """The stacked-mesh transport every round's reduce runs on."""
        return self._routing.transport

    def sync_report(self) -> dict:
        """Per-round sync accounting: one reduce = ``depth`` down +
        ``depth`` up exchanges; host round-trips equal ``run`` calls."""
        return dict(self.report,
                    butterfly_depth=self.planned.depth,
                    reduce_collectives_per_round=2 * self.planned.depth,
                    host_roundtrips=self.report["dispatches"],
                    config_cache=self.config_cache,
                    overlap=self.overlap)

    def _build(self, k: int, collect: str) -> Callable:
        planned, app, routing = self.planned, self.app, self._routing

        def run_k(state, extras):
            last_out, traj = None, None
            for i in range(k):
                last_out = app.out_fn(state, extras)
                in_raw = planned.reduce_on_device(last_out, routing)
                state = app.update_fn(state, in_raw, extras, routing.transport)
                if collect != "trajectory":
                    continue
                if isinstance(state, torch.Tensor):
                    if traj is None:   # one [k, ...] buffer, filled in place
                        traj = state.new_empty((k,) + tuple(state.shape))
                    traj[i].copy_(state)
                else:
                    traj = (traj or []) + [state]
            return state, last_out, traj

        return run_k

    def run_fn(self, k: int, collect: str = "last") -> Callable:
        """The k-round callable ``run(state, extras) -> (final, last_out,
        traj)`` that :meth:`run` invokes, cached per ``(k, collect)``."""
        if collect not in ("last", "trajectory"):
            raise ValueError(f"collect must be 'last' or 'trajectory', "
                             f"got {collect!r}")
        if k < 1:
            raise ValueError(f"need k >= 1 rounds, got {k}")
        fn = self._run_cache.get((k, collect))
        if fn is None:
            fn = self._run_cache[(k, collect)] = self._build(k, collect)
            self.report["step_traces"] += 1
        return fn

    def run(self, k: int, state, extras=None, *, collect: str = "last"):
        """Execute k rounds on the device.

        ``state``: stacked ``[M, ...]`` tensor (or numpy array) per-node
        state, typically ``[M, uin_cap(,W)]``; ``extras``: iteration-
        invariant stacked inputs (e.g. the ELL tables).  Both are moved to
        the engine's device.  Returns ``(final_state, last_out, traj)``
        as device tensors: ``last_out`` is round k's pre-reduce outbound
        values ``[M, u_cap(,W)]``; ``traj`` stacks every round's state when
        ``collect="trajectory"``, else None.
        """
        fn = self.run_fn(k, collect)
        state = to_device(state, self.device)
        extras = to_device(extras if extras is not None else {}, self.device)
        out = fn(state, extras)
        self.report["dispatches"] += 1
        self.report["rounds"] += k
        return out
