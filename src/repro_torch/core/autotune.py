"""Calibrated heterogeneous-degree autotuner with a persistent plan cache (reference: ``repro.core.autotune``).

The paper's throughput claim (§IV) is that the best Sparse Allreduce
network is a nested butterfly of heterogeneous degree decreasing with
depth, chosen by a communication cost model; the model is only as good as
its :class:`~repro_torch.core.netmodel.Fabric`.  Three parts, as in the
reference (TUNING.md):

1. **Calibrate** -- :func:`measure_stage_samples` times single butterfly
   stages (the port's :class:`~repro_torch.core.transport.
   StackedTransport` group exchanges) over a payload x degree sweep on
   the bound device, and :func:`fit_fabric` least-squares fits the
   alpha / beta / gamma terms; :func:`measure_plan` times whole
   ``union_reduce`` calls for modeled-vs-measured checks.  On one card
   the stacked exchanges are index permutations in device memory, so
   the fit describes that, not a network.
2. **Select** -- :func:`select_plan` reranks ``ordered_factorizations``
   under a fabric with the power-law ``expected_counts`` curve,
   optionally confirming the top candidates by timed trial.
3. **Cache** -- :class:`PlanCache` persists degrees and frozen planned
   routing through ``repro_torch.checkpoint.store`` (the reference's
   format), and an in-process memo (LRU of :data:`PLANNED_MEMO_MAX`)
   hands a repeat ``SparseAllreduce.config`` the same plan object and
   reduce callable.

Both packages may share one ``$REPRO_PLAN_CACHE``: every key this module
writes carries ``"backend": "torch"``, which the reference's keys lack,
so neither package is served the other's entries (the frozen arrays are
the same format; :func:`planned_from_artifact` reads either).  Cache
location: ``$REPRO_PLAN_CACHE`` or ``~/.cache/repro/plans``;
``retune=True`` bypasses reads and overwrites.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .netmodel import EC2_2013, Fabric, rate_optimal_allreduce_s
from .topology import ButterflyPlan, check_wire, tune

CACHE_ENV = "REPRO_PLAN_CACHE"
_KEY_VERSION = 1
#: the key field that keeps this package's cache entries apart from the
#: reference's under one root
BACKEND = "torch"

# The two streams a union-path stage ships (uint32 index + f32 value); the
# calibration's byte accounting derives from these itemsizes.
STAGE_IDX_DTYPE = np.dtype(np.uint32)
STAGE_VAL_DTYPE = np.dtype(np.float32)


# ---------------------------------------------------------------------------
# 1. Calibration: stage timings -> least-squares Fabric fit
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StageSample:
    """One observed butterfly-stage timing: ``nbytes`` payload bytes per
    destination, ``fanout`` peers (``k - 1`` for a degree-k stage),
    ``time_s`` seconds for the stage."""
    nbytes: float
    fanout: int
    time_s: float


def synth_stage_samples(fabric: Fabric, payload_bytes: Sequence[float],
                        fanouts: Sequence[int], *, serial: bool = True,
                        noise: float = 0.0, seed: int = 0
                        ) -> List[StageSample]:
    """Stage samples generated from a known fabric (fit-recovery tests);
    ``noise`` is a relative gaussian perturbation."""
    rng = np.random.RandomState(seed)
    out = []
    for b in payload_bytes:
        for f in fanouts:
            t = fabric.stage_time(b, f, serial=serial)
            if noise:
                t *= max(1.0 + noise * float(rng.randn()), 0.05)
            out.append(StageSample(float(b), int(f), max(t, 1e-12)))
    return out


def fit_fabric(samples: Sequence[StageSample], *, serial: bool = True,
               name: str = "calibrated", floor_bytes: float = 0.0) -> Fabric:
    """Least-squares fit of ``Fabric(alpha_s, beta_bytes_per_s, gamma_s)``
    from stage timings.  The stage model is linear in ``(alpha, gamma,
    1/beta)``:

    * serial NIC:  ``t / f = alpha + gamma * (f - 1) + b / beta``
    * per-link:    ``t = f * alpha + gamma * (f - 1) + b / beta``

    one column-scaled ``lstsq``, clamped to alpha > 0, gamma >= 0,
    beta > 0.  Needs >= 3 samples over >= 2 payload sizes (ValueError);
    with a single fanout gamma is pinned to 0 with a warning."""
    if len(samples) < 3:
        raise ValueError(f"need >= 3 samples to fit 3 terms, got {len(samples)}")
    if len({float(s.nbytes) for s in samples}) < 2:
        raise ValueError("need >= 2 distinct payload sizes to identify beta")
    fit_gamma = len({int(s.fanout) for s in samples}) >= 2
    if not fit_gamma:
        warnings.warn(
            "fit_fabric: all samples share one fanout, so the congestion "
            "term is not identifiable from alpha — fitting gamma_s = 0 "
            "(sweep >= 2 stage degrees to calibrate congestion)",
            UserWarning, stacklevel=2)
    rows, ys = [], []
    for s in samples:
        f = max(int(s.fanout), 1)
        gcol = [float(f - 1)] if fit_gamma else []
        if serial:
            rows.append([1.0] + gcol + [float(s.nbytes)])
            ys.append(s.time_s / f)
        else:
            rows.append([float(f)] + gcol + [float(s.nbytes)])
            ys.append(s.time_s)
    a = np.asarray(rows, np.float64)
    y = np.asarray(ys, np.float64)
    scale = np.maximum(np.abs(a).max(axis=0), 1e-30)
    x, *_ = np.linalg.lstsq(a / scale, y, rcond=None)
    x = x / scale
    alpha = max(float(x[0]), 1e-12)
    gamma = max(float(x[1]), 0.0) if fit_gamma else 0.0
    inv_beta = max(float(x[-1]), 1e-18)
    return Fabric(name=name, beta_bytes_per_s=1.0 / inv_beta, alpha_s=alpha,
                  floor_bytes=float(floor_bytes), gamma_s=gamma)


def fit_error(fabric: Fabric, samples: Sequence[StageSample], *,
              serial: bool = True) -> float:
    """Mean relative |modeled - measured| / measured over ``samples``."""
    errs = [abs(fabric.stage_time(s.nbytes, s.fanout, serial=serial)
                - s.time_s) / max(s.time_s, 1e-12) for s in samples]
    return float(np.mean(errs)) if errs else 0.0


def _synchronize(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stage_degrees(m: int, degrees=None) -> Tuple[int, ...]:
    """The stage degrees a calibration over ``m`` nodes sweeps:
    ``degrees`` checked to divide ``m``, or by default the divisors of
    ``m`` among {2, 4, 8, 16, 32, m}."""
    if degrees is None:
        degrees = tuple(dict.fromkeys(
            k for k in (2, 4, 8, 16, 32, m) if 2 <= k <= m and m % k == 0))
    bad = [k for k in degrees if k < 2 or m % k]
    if bad:
        raise ValueError(f"stage degrees {bad} do not divide the node "
                         f"count {m}")
    return tuple(int(k) for k in degrees)


def measure_stage_samples(num_nodes: int, *, device=None,
                          payload_entries=(256, 4096, 32768),
                          degrees: Optional[Sequence[int]] = None,
                          repeats: int = 3, seed: int = 0
                          ) -> List[StageSample]:
    """Time single butterfly stages on the bound device -- the
    calibration microbenchmark.

    For each stage degree k (default: the divisors of ``num_nodes`` among
    {2, 4, 8, 16, 32, num_nodes}) and payload size c, one group
    all_to_all of the stacked transport over contiguous groups of k
    nodes moves the two streams a union stage ships, ``[M, k, c]`` uint32
    indices (held as int32) and f32 values; after a warm-up call, the
    best of ``repeats`` synchronized wall times becomes a
    :class:`StageSample` with ``fanout = k - 1`` and ``nbytes = c * 8``
    per destination."""
    import torch

    from .transport import StackedTransport, resolve_device
    device = resolve_device(device)
    m = int(num_nodes)
    rng = np.random.RandomState(seed)
    samples: List[StageSample] = []
    for k in stage_degrees(m, degrees):
        # the last layer of (m // k, k) groups k contiguous nodes
        plan = ButterflyPlan(m, (k,) if k == m else (m // k, k))
        transport = StackedTransport(plan, device)
        layer = plan.depth - 1
        for c in payload_entries:
            xi = torch.as_tensor(rng.randint(0, 1 << 31, size=(m, k, int(c)))
                                 .astype(np.int32), device=device)
            xv = torch.as_tensor(rng.rand(m, k, int(c)).astype(np.float32),
                                 device=device)
            transport.all_to_all(layer, xi, xv)      # warm-up, untimed
            _synchronize(device)
            best = float("inf")
            for _ in range(repeats):
                t0 = time.perf_counter()
                transport.all_to_all(layer, xi, xv)
                _synchronize(device)
                best = min(best, time.perf_counter() - t0)
            nbytes = float(c) * float(STAGE_IDX_DTYPE.itemsize
                                      + STAGE_VAL_DTYPE.itemsize)
            samples.append(StageSample(nbytes=nbytes, fanout=k - 1,
                                       time_s=best))
            del xi, xv
    return samples


def backend_name(device=None) -> str:
    """The calibration key's backend: ``torch-<device type>``."""
    from .transport import resolve_device
    return f"{BACKEND}-{resolve_device(device).type}"


def calibrate_fabric(num_nodes: int, *, device=None,
                     name: Optional[str] = None, serial: bool = True,
                     store: bool = False,
                     cache: Optional["PlanCache"] = None,
                     **measure_kw) -> Fabric:
    """:func:`measure_stage_samples` + :func:`fit_fabric` in one call;
    ``store=True`` persists the fit (keyed by :func:`backend_name` and
    ``num_nodes``, the stacked node count) for :func:`calibrated_fabric`."""
    samples = measure_stage_samples(num_nodes, device=device, **measure_kw)
    backend = backend_name(device)
    name = name or f"calibrated-{backend}-{num_nodes}"
    fabric = fit_fabric(samples, serial=serial, name=name)
    if store:
        store_calibrated_fabric(fabric, backend=backend,
                                num_devices=num_nodes, cache=cache,
                                residual=fit_error(fabric, samples,
                                                   serial=serial))
    return fabric


def measure_plan(plan: ButterflyPlan, *, entries_per_node: int = 2048,
                 width: int = 1, device=None, merge: str = "sort",
                 repeats: int = 3, seed: int = 0) -> float:
    """Best synchronized wall seconds of one ``union_reduce`` under
    ``plan`` on the bound device (after a warm-up call) -- the timed-trial
    hook of :func:`select_plan` (``confirm=``)."""
    import torch

    from .api import SparseAllreduce
    from .transport import resolve_device
    device = resolve_device(device)
    m = plan.num_nodes
    ar = SparseAllreduce(m, plan.degrees, backend="device", device=device,
                         merge=merge)
    rng = np.random.RandomState(seed)
    idx = np.sort(rng.choice(1 << 20, size=(m, entries_per_node),
                             replace=True).astype(np.uint32), axis=1)
    shape = (m, entries_per_node) + ((width,) if width > 1 else ())
    val = rng.rand(*shape).astype(np.float32)
    cap = min(m * entries_per_node, 1 << 16)
    args = (torch.as_tensor(idx.astype(np.int64), device=device),
            torch.as_tensor(val, device=device))
    ar.union_reduce(*args, out_capacity=cap)
    _synchronize(device)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        ar.union_reduce(*args, out_capacity=cap)
        _synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return best


# ---------------------------------------------------------------------------
# 2. Selection: rerank factorizations under a fabric
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TuneReport:
    """Outcome of one :func:`select_plan` sweep: the winner ``plan`` and
    its modeled seconds, whether it is degree-decreasing, the degenerate
    ``fallback`` (``"prime"`` / ``"depth-extended"``), the top-k
    ``(modeled_s, degrees)`` candidates, the timed-trial seconds when
    confirmation ran, and the rate-optimal bound and the winner's
    fraction of it."""
    plan: ButterflyPlan
    modeled_s: float
    decreasing: bool
    fallback: Optional[str]
    candidates: Tuple[Tuple[float, Tuple[int, ...]], ...]
    measured_s: Optional[Dict[str, float]] = None
    rate_optimal_s: Optional[float] = None
    rate_fraction: Optional[float] = None
    overlap_compute_s: Optional[float] = None


def select_plan(num_nodes: int, n0: float, total_range: float,
                fabric: Fabric = EC2_2013, *,
                bytes_per_entry: float = 12.0, serial_nic: bool = True,
                top_k: int = 5, max_depth: int = 6,
                wire: str = "raw", value_width: int = 1,
                confirm: Optional[Callable[[ButterflyPlan], float]] = None,
                overlap_compute_s: Optional[float] = None
                ) -> TuneReport:
    """Rank all degree sequences under ``fabric`` (``topology.tune``) and
    return a :class:`TuneReport`; ``confirm`` (e.g.
    ``functools.partial(measure_plan, device=...)``) re-ranks the
    ``top_k`` candidates by timed trial.  ``wire`` and
    ``overlap_compute_s`` re-rank under the encoded byte model and the
    overlapped stage model, as in the reference.  A winner that breaks
    the paper's decreasing-degree structure is reported and warned, not
    overridden."""
    check_wire(wire)
    hidden = float(overlap_compute_s or 0.0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        scored = tune(num_nodes, n0, total_range, fabric, bytes_per_entry,
                      serial_nic=serial_nic, top=max(int(top_k), 1),
                      max_depth=max_depth, wire=wire,
                      value_width=value_width, hidden_compute_s=hidden)
    fallback = None
    for w in caught:
        msg = str(w.message)
        if "prime" in msg:
            fallback = "prime"
        elif "truncate" in msg and fallback is None:
            fallback = "depth-extended"
        warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
    candidates = tuple((float(t), p.degrees) for t, p in scored)
    best_t, best = scored[0]
    measured = None
    if confirm is not None and len(scored) > 1:
        measured = {str(p): float(confirm(p)) for _, p in scored}
        best_t, best = min(scored, key=lambda tp: measured[str(tp[1])])
    decreasing = all(a >= b for a, b in zip(best.degrees, best.degrees[1:]))
    if not decreasing:
        warnings.warn(
            f"select_plan: winner {best} violates the paper's "
            f"decreasing-degree structure (SIV) — trust it only if it "
            f"came from a timed trial", UserWarning, stacklevel=2)
    payload = float(n0) * float(bytes_per_entry)
    opt_s = rate_optimal_allreduce_s(payload, num_nodes, fabric)
    return TuneReport(plan=best, modeled_s=float(best_t),
                      decreasing=decreasing, fallback=fallback,
                      candidates=candidates, measured_s=measured,
                      rate_optimal_s=opt_s,
                      rate_fraction=(opt_s / float(best_t)
                                     if best_t > 0 else 0.0),
                      overlap_compute_s=overlap_compute_s)


# ---------------------------------------------------------------------------
# 3. Persistent plan cache (checkpoint/store.py artifacts)
# ---------------------------------------------------------------------------

def cache_root() -> str:
    """Cache directory: ``$REPRO_PLAN_CACHE`` or ``~/.cache/repro/plans``."""
    return os.environ.get(CACHE_ENV) or os.path.join(
        os.path.expanduser("~"), ".cache", "repro", "plans")


def _qlog(x: float) -> float:
    """Half-log2 bucket of the nnz profile (plans are reused across
    <~ 1.4x drift of the workload size)."""
    return round(2.0 * math.log2(max(float(x), 1.0))) / 2.0


def _digest(obj) -> str:
    return hashlib.sha1(
        json.dumps(obj, sort_keys=True).encode()).hexdigest()[:16]


def plan_cache_key(*, mesh: Sequence[Tuple[str, int]], nnz: float,
                   index_range: float, merge: str, replication: int,
                   width: int, fabric: Fabric,
                   serial_nic: bool = True,
                   shrunk_from: Optional[int] = None,
                   wire: str = "raw",
                   overlap_compute_s: float = 0.0) -> dict:
    """The degree-cache key: the reference's fields (node layout,
    quantized nnz profile, merge mode, replication, value width, fabric,
    NIC mode, key version; ``shrunk_from``, a non-raw ``wire`` and a
    nonzero ``overlap_compute_s`` only when set) plus ``"backend":
    "torch"``.  Any field changing is a different entry."""
    key = {
        "kind": "plan", "version": _KEY_VERSION,
        "mesh": [[str(a), int(s)] for a, s in mesh],
        "nnz_bucket": _qlog(nnz), "range_bucket": _qlog(index_range),
        "merge": str(merge), "replication": int(replication),
        "width": int(width),
        "fabric": fabric.as_meta(),
        "serial_nic": bool(serial_nic),
        "backend": BACKEND,
    }
    if shrunk_from is not None:
        key["shrunk_from"] = int(shrunk_from)
    if check_wire(wire) != "raw":
        key["wire"] = str(wire)
    if overlap_compute_s:
        key["overlap_bucket"] = _qlog(
            float(overlap_compute_s) * fabric.beta_bytes_per_s)
    return key


def fabric_cache_key(*, backend: str, num_devices: int) -> dict:
    """Key of a persisted calibration: one fitted fabric per (backend
    name, node count); the port's backend names start ``torch-``."""
    return {"kind": "fabric", "version": _KEY_VERSION,
            "backend": str(backend), "num_devices": int(num_devices)}


class PlanCache:
    """Directory of ``checkpoint/store.py`` artifacts keyed by digest:
    ``<kind>-<digest>.npz`` (routing arrays of plan entries) +
    ``.meta.json`` (degrees, staging metadata, the full key).  IO errors
    degrade to misses (``stats["errors"]``): a broken cache can slow a
    run down but never stop it."""

    def __init__(self, root: Optional[str] = None):
        self._root = root
        self.stats = {"hits": 0, "misses": 0, "stores": 0, "errors": 0}

    @property
    def root(self) -> str:
        """Resolved cache directory (the variable re-read when not
        pinned)."""
        return self._root or cache_root()

    def path(self, key: dict) -> str:
        """Extension-less artifact path for ``key``."""
        return os.path.join(self.root, f"{key['kind']}-{_digest(key)}")

    def load(self, key: dict):
        """``(meta, arrays)`` for ``key`` or ``None`` (a counted miss)."""
        p = self.path(key)
        if not os.path.exists(p + ".meta.json"):
            self.stats["misses"] += 1
            return None
        try:
            from repro_torch.checkpoint.store import load_flat
            if os.path.exists(p + ".npz"):
                arrays, meta = load_flat(p)
            else:
                arrays = {}
                with open(p + ".meta.json") as f:
                    meta = json.load(f)
            self.stats["hits"] += 1
            return meta, arrays
        except Exception:
            self.stats["errors"] += 1
            return None

    def store(self, key: dict, meta: dict,
              arrays: Optional[Dict[str, np.ndarray]] = None) -> None:
        """Persist ``meta`` (+ optional ``arrays``) under ``key``."""
        try:
            from repro_torch.checkpoint.store import save
            save(self.path(key), arrays if arrays else
                 {"empty": np.zeros(0, np.int32)},
                 meta={**meta, "key": key})
            self.stats["stores"] += 1
        except OSError:
            self.stats["errors"] += 1

    def invalidate(self, key: dict) -> None:
        """Drop ``key``'s artifact."""
        p = self.path(key)
        for ext in (".npz", ".meta.json"):
            try:
                os.remove(p + ext)
            except OSError:
                pass


_DEFAULT_CACHE: Optional[PlanCache] = None


def default_cache() -> PlanCache:
    """Process-wide :class:`PlanCache` rooted at :func:`cache_root`."""
    global _DEFAULT_CACHE
    if _DEFAULT_CACHE is None:
        _DEFAULT_CACHE = PlanCache()
    return _DEFAULT_CACHE


def fabric_from_meta(meta: dict) -> Fabric:
    """Inverse of ``Fabric.as_meta``."""
    return Fabric(name=str(meta["name"]),
                  beta_bytes_per_s=float(meta["beta_bytes_per_s"]),
                  alpha_s=float(meta["alpha_s"]),
                  floor_bytes=float(meta.get("floor_bytes", 0.0)),
                  gamma_s=float(meta.get("gamma_s", 0.0)))


def store_calibrated_fabric(fabric: Fabric, *, backend: str,
                            num_devices: int,
                            cache: Optional[PlanCache] = None,
                            residual: Optional[float] = None) -> None:
    """Persist a fitted fabric for :func:`calibrated_fabric` lookups."""
    cache = cache or default_cache()
    meta = {"fabric": fabric.as_meta()}
    if residual is not None:
        meta["fit_residual"] = float(residual)
    cache.store(fabric_cache_key(backend=backend,
                                 num_devices=num_devices), meta)


def calibrated_fabric(*, backend: str, num_devices: int,
                      cache: Optional[PlanCache] = None,
                      default: Optional[Fabric] = None) -> Optional[Fabric]:
    """The persisted calibration for (backend, node count), or
    ``default``."""
    cache = cache or default_cache()
    hit = cache.load(fabric_cache_key(backend=backend,
                                      num_devices=num_devices))
    if hit is None:
        return default
    meta, _ = hit
    return fabric_from_meta(meta["fabric"])


# ---------------------------------------------------------------------------
# resolve_degrees: what degrees="auto" goes through
# ---------------------------------------------------------------------------

def resolve_degrees(num_nodes: int, *, n0: float, total_range: float,
                    fabric: Fabric = EC2_2013, merge: str = "sort",
                    replication: int = 1, width: int = 1,
                    serial_nic: bool = True,
                    mesh_sig: Optional[Sequence[Tuple[str, int]]] = None,
                    cache: Optional[PlanCache] = None,
                    retune: bool = False, top_k: int = 5,
                    confirm: Optional[Callable] = None,
                    shrunk_from: Optional[int] = None,
                    wire: str = "raw"
                    ) -> Tuple[Tuple[int, ...], str]:
    """Cached degree selection: ``(degrees, source)`` with ``source`` in
    ``{"cache", "tuned"}``.  Reads the :class:`PlanCache` first (unless
    ``retune``), else runs :func:`select_plan` and stores the result.
    ``mesh_sig`` defaults to ``(("nodes", num_nodes),)``;
    ``shrunk_from`` keys survivor replans apart (a repeat shrink to the
    same survivor count is a hit); ``wire`` tunes under the encoded byte
    model and keys per wire format."""
    cache = cache or default_cache()
    sig = tuple(mesh_sig) if mesh_sig else (("nodes", int(num_nodes)),)
    if math.prod(s for _, s in sig) != num_nodes:
        raise ValueError(f"mesh_sig {sig} does not cover {num_nodes} nodes")
    key = plan_cache_key(mesh=sig, nnz=n0, index_range=total_range,
                         merge=merge, replication=replication, width=width,
                         fabric=fabric, serial_nic=serial_nic,
                         shrunk_from=shrunk_from, wire=wire)
    if not retune:
        hit = cache.load(key)
        if hit is not None:
            meta, _ = hit
            degrees = tuple(int(d) for d in meta.get("degrees", ()))
            if math.prod(degrees) == num_nodes or (
                    num_nodes == 1 and degrees == ()):
                return degrees, "cache"
    report = select_plan(num_nodes, n0, total_range, fabric,
                         serial_nic=serial_nic, top_k=top_k,
                         wire=wire, value_width=width,
                         confirm=confirm)
    cache.store(key, {
        "degrees": [int(d) for d in report.plan.degrees],
        "num_nodes": int(num_nodes),
        "modeled_s": report.modeled_s,
        "decreasing": report.decreasing,
        "fallback": report.fallback,
        "candidates": [[t, list(d)] for t, d in report.candidates],
        "measured_s": report.measured_s,
        "n0": float(n0), "total_range": float(total_range),
        "serial_nic": bool(serial_nic), "wire": str(wire),
    })
    return report.plan.degrees, "tuned"


# ---------------------------------------------------------------------------
# Frozen-plan persistence + in-process memo
# ---------------------------------------------------------------------------

plan_memo_stats = {"hits": 0, "misses": 0, "disk_hits": 0}
_PLANNED_MEMO: Dict[str, tuple] = {}   # insertion-ordered: LRU via re-insert
#: frozen plans hold routing on a device; the memo is capped so a process
#: whose index pattern keeps changing cannot grow without bound
PLANNED_MEMO_MAX = 64
_PLANNER_FILES = ("planned.py", "simulator.py", "topology.py",
                  "sparse_vec.py", "replication.py")
_PLANNER_VERSION: Optional[str] = None


def planner_version() -> str:
    """Digest of the port's five source modules that frozen routing
    depends on; part of every planned artifact's key, so editing the
    planning code invalidates artifacts of older code."""
    global _PLANNER_VERSION
    if _PLANNER_VERSION is None:
        h = hashlib.sha1()
        here = os.path.dirname(os.path.abspath(__file__))
        for fname in _PLANNER_FILES:
            with open(os.path.join(here, fname), "rb") as f:
                h.update(f.read())
        _PLANNER_VERSION = h.hexdigest()[:12]
    return _PLANNER_VERSION


def planned_cache_key(fingerprint: str) -> dict:
    """Disk key of one frozen-config artifact (the fingerprint embeds
    :func:`planner_version`)."""
    return {"kind": "planned", "version": _KEY_VERSION, "fp": fingerprint,
            "backend": BACKEND}


def clear_plan_memo() -> None:
    """Drop the in-process planned memo (tests, a simulated restart)."""
    _PLANNED_MEMO.clear()
    plan_memo_stats.update(hits=0, misses=0, disk_hits=0)


def _nodes_fingerprint(device, nodes: Sequence[int]) -> tuple:
    """The port's stand-in for the reference's mesh fingerprint: the
    stacked node axis, the pool positions hosting it and the device the
    routing lives on."""
    return (("nodes",), (len(nodes),), tuple(int(p) for p in nodes),
            str(device))


def planned_fingerprint(device, nodes: Sequence[int],
                        degrees: Sequence[int], replication: int,
                        dead, width: int, perm,
                        out_indices: Sequence[np.ndarray],
                        in_indices: Sequence[np.ndarray],
                        fabric: Optional[Fabric] = None) -> str:
    """Digest identifying one frozen config: device and node positions,
    plan shape, planner version, the exact index pattern (and the stats
    fabric).  Same fingerprint: the frozen routing and its reduce
    callable are reusable as they are."""
    h = hashlib.sha1()
    h.update(repr((_nodes_fingerprint(device, nodes),
                   tuple(int(d) for d in degrees),
                   int(replication), tuple(sorted(dead or ())), int(width),
                   int(perm.mult), int(perm.xor), planner_version(),
                   None if fabric is None else
                   sorted(fabric.as_meta().items()))).encode())
    for group in (out_indices, in_indices):
        h.update(b"|group|")
        for arr in group:
            a = np.ascontiguousarray(np.asarray(arr))
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
    return h.hexdigest()


def memo_lookup(fingerprint: str):
    """Memo read (None on a miss); a hit refreshes its LRU recency."""
    hit = _PLANNED_MEMO.pop(fingerprint, None)
    if hit is not None:
        _PLANNED_MEMO[fingerprint] = hit
    plan_memo_stats["hits" if hit is not None else "misses"] += 1
    return hit


def memo_store(fingerprint: str, value: tuple) -> None:
    """Memo write (LRU-evicts past :data:`PLANNED_MEMO_MAX`)."""
    _PLANNED_MEMO[fingerprint] = value
    while len(_PLANNED_MEMO) > PLANNED_MEMO_MAX:
        _PLANNED_MEMO.pop(next(iter(_PLANNED_MEMO)))


def stats_to_meta(stats) -> dict:
    """``ReduceStats`` -> JSON-able dict."""
    return {"config_time_s": stats.config_time_s,
            "reduce_time_s": stats.reduce_time_s,
            "overflow": int(stats.overflow),
            "stages": [dataclasses.asdict(s) for s in stats.stages]}


def stats_from_meta(meta: dict):
    """Inverse of :func:`stats_to_meta`."""
    from .simulator import ReduceStats, StageStats
    return ReduceStats(
        config_time_s=float(meta.get("config_time_s", 0.0)),
        reduce_time_s=float(meta.get("reduce_time_s", 0.0)),
        overflow=int(meta.get("overflow", 0)),
        stages=[StageStats(**s) for s in meta.get("stages", [])])


def planned_to_artifact(planned) -> Tuple[Dict[str, np.ndarray], dict]:
    """A ``PlannedSparseAllreduce`` as ``(arrays, meta)``: every frozen
    routing array plus the scalars and ``make_device_plan`` arguments
    that rebuild it (:func:`planned_from_artifact`); the reference's
    format, array for array."""
    arrays = {"user_scatter": planned.user_scatter,
              "bottom_gather": planned.bottom_gather,
              "bottom_hit": planned.bottom_hit,
              "user_gather": planned.user_gather}
    if planned.weights is not None:
        arrays["weights"] = np.asarray(planned.weights)
    layer_meta = []
    for i, L in enumerate(planned.layers):
        arrays[f"layer{i}/send_gather"] = L.send_gather
        arrays[f"layer{i}/merge_scatter"] = L.merge_scatter
        arrays[f"layer{i}/up_send_gather"] = L.up_send_gather
        arrays[f"layer{i}/up_recv_scatter"] = L.up_recv_scatter
        layer_meta.append({"merged_size": int(L.merged_size),
                           "up_size": int(L.up_size)})
    dp = planned.dplan
    meta = {
        "sorted_size": int(planned.sorted_size),
        "in_user_len": int(planned.in_user_len),
        "width": int(planned.width),
        "perm": {"mult": int(planned.perm.mult),
                 "xor": int(planned.perm.xor)},
        "layers": layer_meta,
        "dplan": {
            "axes": [[a, int(s)] for a, s in dp.axes],
            "in_capacity": int(dp.in_capacity),
            "out_capacity": int(dp.out_capacity),
            "replication": int(dp.replication),
        },
    }
    return arrays, meta


def planned_from_artifact(arrays: Dict[str, np.ndarray], meta: dict,
                          degrees_per_axis: Dict[str, Tuple[int, ...]],
                          device=None):
    """Rebuild a ``PlannedSparseAllreduce`` from an artifact of either
    package (``planned.planned_from_reference``); ``degrees_per_axis``
    is the logical per-axis degree dict of the original plan."""
    from .planned import planned_from_reference
    return planned_from_reference(arrays, meta, degrees_per_axis,
                                  device=device)
