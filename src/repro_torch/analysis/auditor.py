"""Dispatch audits of the port's entry points (reference: ``repro.analysis.auditor``).

The reference traces each entry point to a jaxpr and reads its
collectives and primitives.  The port runs the entry point once, on the
device it is given, under two censuses:

* :class:`OpCensus`, a ``TorchDispatchMode`` that records every aten op
  with its result dtypes and devices, and flags host reads
  (``aten._local_scalar_dense``: ``.item()``, ``bool()`` of a tensor),
  copies from a CUDA tensor to the CPU, and float64 results;
* :class:`ExchangeCensus`, which wraps the exchange methods of
  ``StackedTransport`` (``all_to_all``, ``all_gather``,
  ``reduce_scatter``, ``psum``, ``pmax``) and ``ModelAxis``
  (``all_to_all``, ``all_gather``) for its duration and records each
  exchange's kind, axis, layer and bytes in issue order (a ``psum`` /
  ``pmax`` over several data axes counts one an axis, as the
  reference's per-axis collectives do), and counts
  ``torch.cuda.synchronize`` calls.

The reference's checks map onto them: one reduce issues exactly ``2 *
planned.depth`` exchanges (:func:`audit_reduce`); a ``GraphEngine.run``
is one dispatch -- on a CUDA device exactly one graph replay, whose
rounds were recorded when the graph was captured (a replay dispatches no
aten op), on the CPU one eager loop -- and each round issues ``2 *
depth`` exchanges plus the app's declared ones, with the rotated
schedule's ``depth`` before its round loop and ``depth`` + extra after
it (:func:`audit_engine`); the bucketed stage-major sync is a pure
reordering of its bucket-major twin (:func:`audit_overlap_sync`); a
greedy serving step returns integer ids and no vocab-sized float tensor
(:func:`audit_serve_decode`).  Every audit adds the base checks: no host
read and no device-to-host copy inside the call, no float64 result.
"""
from __future__ import annotations

import contextlib
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core.transport import ModelAxis, StackedTransport

from .violations import AuditReport, CheckResult

# the exchange methods the census wraps, per class, and the axis they act on
_EXCHANGES = {StackedTransport: ("data", ("all_to_all", "all_gather",
                                          "reduce_scatter", "psum", "pmax")),
              ModelAxis: ("model", ("all_to_all", "all_gather"))}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _span_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor addresses (a broadcast
    view's stride-0 dims count once)."""
    if t.numel() == 0:
        return 0
    span = 1 + sum((n - 1) * abs(st) for n, st in zip(t.shape, t.stride()))
    return min(span, t.numel()) * t.element_size()


class OpCensus(TorchDispatchMode):
    """Every aten op the call dispatches: ``ops`` (a Counter of op names),
    ``host_reads`` (``_local_scalar_dense``), ``dtoh`` (ops with a CUDA
    input and a CPU result), ``f64`` (ops with a float64 result), and
    ``op_bytes``: every non-view op's input and output bytes summed (each
    tensor's distinct elements), the bytes an unfused run would move."""

    def __init__(self):
        super().__init__()
        self.ops: Counter = Counter()
        self.host_reads: List[str] = []
        self.dtoh: List[str] = []
        self.f64: List[str] = []
        self.op_bytes = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.name()
        self.ops[name] += 1
        if func is torch.ops.aten._local_scalar_dense.default:
            self.host_reads.append(name)
        outs, ins = _tensors(out), _tensors((args, kwargs))
        if not func.is_view:
            self.op_bytes += sum(_span_bytes(t) for t in ins + outs)
        if any(t.device.type == "cpu" for t in outs) and any(
                t.device.type == "cuda" for t in ins):
            self.dtoh.append(name)
        if any(t.dtype == torch.float64 for t in outs):
            self.f64.append(name)
        return out


class ExchangeCensus:
    """The exchanges issued while the census is entered: ``records`` a
    list of ``{"kind", "axis", "layer", "bytes", "group", "result_bytes",
    "transport"}`` in issue order (layer None for the sums and the model
    axis; ``bytes`` the stacked operands', ``group`` the exchange's group
    size k, ``result_bytes`` one position's result), ``syncs`` the
    ``torch.cuda.synchronize`` calls.  ``marks`` holds the labels an
    audit pushes with :meth:`mark` and the record count at each."""

    def __init__(self):
        self.records: List[Dict[str, Any]] = []
        self.marks: List[Tuple[str, int]] = []
        self.syncs = 0
        self._saved = []

    def __enter__(self):
        for cls, (axis, names) in _EXCHANGES.items():
            for name in names:
                orig = cls.__dict__[name]
                self._saved.append((cls, name, orig))
                setattr(cls, name, self._wrap(orig, name, axis))
        sync = torch.cuda.synchronize
        self._saved.append((torch.cuda, "synchronize", sync))

        def counted(*a, **k):
            self.syncs += 1
            return sync(*a, **k)
        torch.cuda.synchronize = counted
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved = []
        return False

    def _wrap(self, orig, kind, axis):
        census = self

        def wrapped(obj, *args, **kwargs):
            layer = None
            if kind in ("psum", "pmax"):
                ax = args[1] if len(args) > 1 else kwargs.get("axes")
                groups, xs = tuple(ax or (obj.num_nodes,)), args[:1]
            elif axis == "model":
                groups, xs = (obj.tp,), args
            else:
                layer, xs = args[0], args[1:]
                groups = (obj.plan.degrees[layer],)
            nbytes = sum(t.numel() * t.element_size() for t in _tensors(xs))
            # one position's result: the stacked operand over its positions
            if axis == "model":
                per = nbytes / (xs[0].shape[0] * obj.tp)
                per *= obj.tp if kind == "all_gather" else 1
            else:
                per = nbytes / obj.num_nodes
                per *= {"all_gather": groups[0],
                        "reduce_scatter": 1.0 / groups[0]}.get(kind, 1)
            for k in groups:
                census.records.append({"kind": kind, "axis": axis,
                                       "layer": layer, "bytes": nbytes,
                                       "group": k, "result_bytes": per,
                                       "transport": id(obj)})
            return orig(obj, *args, **kwargs)
        return wrapped

    def mark(self, label: str) -> None:
        """Note ``label`` at the current record count."""
        self.marks.append((label, len(self.records)))

    def counts(self, axis: Optional[str] = None) -> Counter:
        """Exchange kinds (of ``axis`` only, when given) as a Counter."""
        return Counter(r["kind"] for r in self.records
                       if axis is None or r["axis"] == axis)


@contextlib.contextmanager
def censused():
    """Both censuses over a block: yields ``(ops, exchanges)``."""
    with ExchangeCensus() as ex, OpCensus() as ops:
        yield ops, ex


def base_checks(ops: OpCensus, ex: ExchangeCensus, prefix: str = ""
                ) -> List[CheckResult]:
    """The invariants of every audited call: no host read and no
    device-to-host copy (the reference's forbidden primitives: callbacks
    and transfers), no float64 result."""
    leaks = sorted(set(ops.host_reads + ops.dtoh))
    return [
        CheckResult(f"{prefix}no_forbidden_primitives", not leaks,
                    expected=[], actual=leaks,
                    detail=f"host reads {len(ops.host_reads)}, "
                           f"device-to-host copies {len(ops.dtoh)}, "
                           f"synchronize calls {ex.syncs}"),
        CheckResult(f"{prefix}no_float64", not ops.f64, expected=0,
                    actual=len(ops.f64),
                    detail="device paths are float32 at the widest"),
    ]


# ---------------------------------------------------------------------------
# entry-point audits
# ---------------------------------------------------------------------------

def audit_reduce(sa, width: Optional[int] = None) -> AuditReport:
    """One configured device ``SparseAllreduce``: its ``reduce_fn`` on a
    zeros input of the staged shape issues exactly ``2 * planned.depth``
    exchanges (``depth`` down, ``depth`` up; a replication r > 1 stage is
    in ``planned.depth``), plus the base checks."""
    planned, device = sa.planned_parts()
    meta = sa.staging_metadata()
    w = width if width is not None else getattr(sa, "width", 1)
    shape = (meta["num_physical"], meta["u_cap"]) + ((w,) if w > 1 else ())
    x = torch.zeros(shape, dtype=torch.float32, device=device)
    with censused() as (ops, ex):
        sa.reduce_fn(x)
    n, expected = len(ex.records), 2 * planned.depth
    checks = [CheckResult("collectives_equal_plan_depth", n == expected,
                          expected=expected, actual=n,
                          detail=f"depth={planned.depth} (down + up); all "
                                 f"exchanges: {dict(ex.counts())}")]
    checks += base_checks(ops, ex)
    return AuditReport(
        target=f"SparseAllreduce.reduce_fn[depth={planned.depth}, "
               f"r={getattr(sa, 'replication', 1)}]", checks=checks)


def audit_engine(engine, k: int, state, extras=None, *,
                 collect: str = "last",
                 extra_collectives_per_round: int = 0) -> AuditReport:
    """A ``GraphEngine``'s k-round ``run``, from a fresh ``(k,
    collect)`` program.

    ``one_scan_dispatch``: the run is one dispatch -- on a CUDA device
    ``report["graph_launches"]`` rises by exactly 1 (one replay), on the
    CPU one eager loop.  ``per_round_collectives_equal_plan_depth``:
    every round's reduce issues ``2 * depth`` exchanges and the update
    ``extra_collectives_per_round``; on a CUDA device these are read from
    the capture (the rounds the graph holds), which a replay re-runs
    without dispatching.  The plain schedule has every reduce whole
    inside a round (``no_collectives_outside_scan``); with ``overlap``
    and k >= 2 the rotated schedule issues ``depth`` exchanges (round 1's
    down half) before its round loop and ``depth`` + extra (round k's up
    half and update) after it (``prologue_epilogue_split``).
    ``scan_carry_dtypes_stable``: every update returns the state's
    dtypes.  Plus the base checks."""
    planned, app = engine.planned, engine.app
    depth = planned.depth
    overlapped = bool(getattr(engine, "overlap", False)) and k >= 2
    engine._run_cache.pop((k, collect), None)
    saved = {"eager_fn": engine.eager_fn, "out": app.out_fn,
             "update": app.update_fn,
             "reduce": planned.reduce_on_device,
             "down": planned.reduce_down_on_device,
             "up": planned.reduce_up_on_device}
    carries: List[str] = []
    with censused() as (ops, ex):
        def loop(kk, coll="last"):
            fn = saved["eager_fn"](kk, coll)

            def run(*a):
                ex.mark(f"run{kk}")
                return fn(*a)
            return run

        def update(st, *a):
            ex.mark("update")
            new = saved["update"](st, *a)
            carries.extend(f"{a.dtype} -> {b.dtype}" for a, b in
                           zip(_tensors(st), _tensors(new))
                           if a.dtype != b.dtype)
            ex.mark("updated")
            return new

        def marked(label):
            def fn(*a, **kw):
                ex.mark(label)
                out = saved[label](*a, **kw)
                ex.mark("/" + label)
                return out
            return fn

        engine.eager_fn = loop
        object.__setattr__(app, "out_fn", marked("out"))   # a frozen app
        object.__setattr__(app, "update_fn", update)
        for label in ("reduce", "down", "up"):
            setattr(planned, f"{label}_on_device" if label == "reduce"
                    else f"reduce_{label}_on_device", marked(label))
        launches = engine.report["graph_launches"]
        dispatches = engine.report["dispatches"]
        try:
            engine.run(k, state, extras, collect=collect)
        finally:
            del engine.__dict__["eager_fn"]
            object.__setattr__(app, "out_fn", saved["out"])
            object.__setattr__(app, "update_fn", saved["update"])
            for name in ("reduce_on_device", "reduce_down_on_device",
                         "reduce_up_on_device"):
                planned.__dict__.pop(name, None)
    on_card = engine.device.type == "cuda"
    launched = engine.report["graph_launches"] - launches
    one = (launched == 1) if on_card else \
        (engine.report["dispatches"] - dispatches == 1 and launched == 0)
    # the audited rounds: the last k-round loop (a capture's warm-up
    # rounds run before it)
    start = max(i for i, (lab, _) in enumerate(ex.marks)
                if lab == f"run{k}")
    marks = ex.marks[start:]
    first, total = marks[0][1], len(ex.records)
    spans = {lab: [] for lab in ("reduce", "down", "up", "update")}
    opened = {}
    for lab, at in marks:
        if lab in spans:
            opened[lab] = at
        elif lab.startswith("/") and lab[1:] in spans:
            spans[lab[1:]].append(at - opened.pop(lab[1:]))
        elif lab == "updated":
            spans["update"].append(at - opened.pop("update"))
    extra = extra_collectives_per_round
    reduces = [a for a in spans["reduce"]] if not overlapped else \
        [a + b for a, b in zip(spans["down"], spans["up"])]
    per_round = [r + u for r, u in zip(reduces, spans["update"])]
    expected_round = 2 * depth + extra
    checks = [CheckResult(
        "one_scan_dispatch", one, expected=1,
        actual=launched if on_card else engine.report["dispatches"]
        - dispatches,
        detail="one CUDA graph replay a run" if on_card
        else "one eager k-round loop a run (no graph on the CPU)")]
    if overlapped:
        down_marks = [at for lab, at in marks if lab == "down"]
        loop_start = down_marks[0] if down_marks else first
        before = spans["down"][0] if spans["down"] else -1
        after = (spans["up"][-1] + spans["update"][-1]) \
            if spans["up"] and spans["update"] else -1
        checks.append(CheckResult(
            "prologue_epilogue_split",
            before == depth and after == depth + extra
            and loop_start == first,
            expected={"before_loop": depth, "after_loop": depth + extra},
            actual={"before_loop": before, "after_loop": after},
            detail="rotated schedule: round 1's down half before the "
                   "round loop, round k's up half and update after it"))
    else:
        outside = total - first - sum(per_round)
        checks.append(CheckResult(
            "no_collectives_outside_scan", outside == 0,
            expected=0, actual=outside,
            detail="every exchange belongs to a round's reduce or update"))
    checks.append(CheckResult(
        "per_round_collectives_equal_plan_depth",
        len(per_round) == k and all(n == expected_round for n in per_round),
        expected=[expected_round] * k, actual=per_round,
        detail=f"2*depth={2 * depth} reduce + {extra} app-declared"
               + ("; read at capture" if on_card else "")))
    checks.append(CheckResult(
        "scan_carry_dtypes_stable", not carries, expected=[],
        actual=carries, detail="an update that widens the state "
                               "re-converts it every round"))
    checks += base_checks(ops, ex)
    return AuditReport(
        target=f"GraphEngine.run[k={k}, collect={collect}, depth={depth}, "
               f"overlap={overlapped}]", checks=checks)


def _runs(seq: Sequence) -> List[Tuple[Any, int]]:
    """``(item, run_length)`` maximal runs of a sequence."""
    runs: List[Tuple[Any, int]] = []
    for item in seq:
        if runs and runs[-1][0] == item:
            runs[-1] = (item, runs[-1][1] + 1)
        else:
            runs.append((item, 1))
    return runs


def audit_overlap_sync(name: str, overlapped_fn, sequential_fn,
                       *example_args, depth: int,
                       n_buckets: int) -> AuditReport:
    """A bucketed stage-major sync against its bucket-major twin (the
    same buckets, one whole ``2 * depth`` chain a bucket), both run on
    ``example_args``: ``same_total_collectives`` (the same multiset of
    exchange kind, layer and bytes), ``bucket_collective_count`` (``depth
    * n_buckets`` reduce-scatters and as many all-gathers),
    ``stage_major_interleaving`` (``2 * depth`` runs of ``n_buckets``
    same-layer exchanges: the reduce-scatter layers in order, then the
    all-gather layers mirroring them), ``no_barriers`` (no synchronize
    inside), plus the base checks of the overlapped run."""
    with censused() as (ops, ex_o):
        overlapped_fn(*example_args)
    with ExchangeCensus() as ex_s:
        sequential_fn(*example_args)

    def multiset(ex):
        return Counter((r["kind"], r["layer"], r["bytes"])
                       for r in ex.records)
    c_o = ex_o.counts()
    seq = [(r["kind"], r["layer"]) for r in ex_o.records
           if r["kind"] in ("reduce_scatter", "all_gather")]
    runs = _runs(seq)
    shape_ok = len(runs) == 2 * depth and all(n == n_buckets
                                              for _, n in runs)
    rs = [layer for (kind, layer), _ in runs if kind == "reduce_scatter"]
    ag = [layer for (kind, layer), _ in runs if kind == "all_gather"]
    phase_ok = all(kind == "reduce_scatter" for (kind, _), _ in runs[:depth])
    checks = [
        CheckResult("same_total_collectives", multiset(ex_o) == multiset(ex_s),
                    expected=dict(ex_s.counts()), actual=dict(c_o),
                    detail="a pure reordering of the sequential schedule's "
                           "exchanges (kind, layer and bytes)"),
        CheckResult("bucket_collective_count",
                    c_o.get("reduce_scatter", 0) == depth * n_buckets
                    and c_o.get("all_gather", 0) == depth * n_buckets,
                    expected={"reduce_scatter": depth * n_buckets,
                              "all_gather": depth * n_buckets},
                    actual={k: c_o.get(k, 0)
                            for k in ("reduce_scatter", "all_gather")},
                    detail=f"2*depth={2 * depth} exchanges a bucket, "
                           f"{n_buckets} buckets"),
        CheckResult("stage_major_interleaving",
                    shape_ok and phase_ok and ag == rs[::-1],
                    expected=f"{depth} runs of {n_buckets} reduce_scatter "
                             f"then {depth} runs of {n_buckets} all_gather "
                             f"(mirrored layers)",
                    actual=[(kind, layer, n) for (kind, layer), n in runs],
                    detail="every bucket's layer-l exchange issues before "
                           "any bucket's layer l + 1"),
        CheckResult("no_barriers", ex_o.syncs == 0 and not ops.host_reads,
                    expected=0, actual=ex_o.syncs + len(ops.host_reads),
                    detail="a synchronize or host read would force the "
                           "order the schedule frees"),
    ]
    checks += base_checks(ops, ex_o, prefix="overlap_")
    return AuditReport(target=f"{name}[depth={depth}, buckets={n_buckets}]",
                       checks=checks)


def audit_callable(name: str, fn, *example_args,
                   expected_all_to_all: Optional[int] = None) -> AuditReport:
    """Any entry point (e.g. a train step) run once: the base checks and
    an informational exchange census, or, with ``expected_all_to_all``,
    an exact count of the exchanges (every kind: on the stacked mesh an
    exchange is one index permutation, whatever the collective)."""
    with censused() as (ops, ex):
        fn(*example_args)
    counts = ex.counts()
    if expected_all_to_all is not None:
        n = len(ex.records)
        checks = [CheckResult("all_to_all_count", n == expected_all_to_all,
                              expected=expected_all_to_all, actual=n,
                              detail=f"all exchanges: {dict(counts)}")]
    else:
        checks = [CheckResult("collective_census", True, expected=None,
                              actual=dict(counts), detail="informational")]
    checks += base_checks(ops, ex)
    return AuditReport(target=name, checks=checks)


def audit_serve_decode(name: str, fn, *example_args,
                       vocab: int) -> AuditReport:
    """The serving tier's contract: a fused greedy step returns token ids,
    never logits.  ``no_vocab_sized_float_output``: no floating output
    of rank <= 2 whose last dim is >= ``vocab`` (the cache's leaves have
    rank >= 3); ``token_ids_output_is_integer``: some output is an
    integer tensor; plus the base checks (no host read or device-to-host
    copy inside the step)."""
    with censused() as (ops, ex):
        out = fn(*example_args)
    bad, has_int = [], False
    for t in _tensors(out):
        if not t.dtype.is_floating_point and t.dtype != torch.bool:
            has_int = True
        if t.dtype.is_floating_point and 1 <= t.ndim <= 2 \
                and t.shape[-1] >= vocab:
            bad.append(f"{str(t.dtype).replace('torch.', '')}"
                       f"[{','.join(map(str, t.shape))}]")
    checks = [
        CheckResult("no_vocab_sized_float_output", not bad, expected=[],
                    actual=bad, detail="the decode loop must transfer "
                                       "token ids, never vocab logits"),
        CheckResult("token_ids_output_is_integer", has_int, expected=True,
                    actual=has_int,
                    detail="greedy sampling happens on the device"),
    ]
    checks += base_checks(ops, ex)
    return AuditReport(target=name, checks=checks)
