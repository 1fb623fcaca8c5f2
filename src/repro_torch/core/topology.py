"""Heterogeneous-degree nested butterfly topology (reference: ``repro.core.topology``).

Paper §II-A.3, §IV-B.  Pure numpy, copied from the reference so that the
port never imports ``repro`` (whose ``core`` package init imports jax).

A plan over M nodes is an ordered degree sequence ``[k_1, ..., k_D]`` with
``prod(k) == M``.  Node ids are mixed-radix numbers with digit 1 most
significant; the layer-l group of a node is the set of k_l nodes that differ
from it only in digit l.  The hashed index space [0, 2^32) is recursively
range-partitioned: at layer l each group splits its current range into k_l
contiguous sub-ranges, one per digit value — so after D layers node n owns
exactly the [n/M, (n+1)/M) slice of the hashed space.

Degenerate corners of the family (paper §II):
  * ``[M]``      -> round-robin (single all-to-all stage)
  * ``[2]*log M`` -> binary butterfly
  * anything else -> the paper's hybrid.

The planner also carries the paper's packet-size/compression model (Fig 5)
and an alpha-beta-floor cost estimate used by the tuner (Fig 6).
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .netmodel import EC2_2013, Fabric

SPACE = 1 << 32  # hashed index space size

# Union-path wire formats (device codecs in repro.kernels.wirecodec; here
# they only change the modeled bytes-per-entry).  "raw" ships uint32 index
# + fp32 value (4+4 B/entry); the "delta" family bit-packs indices as
# offsets from the stage subrange base (width shrinks with depth) and
# optionally narrows values to bf16 or per-row-scaled int8.
WIRE_MODES = ("raw", "delta", "delta+bf16", "delta+int8ef")

_WIRE_VALUE_BYTES = {"raw": 4.0, "delta": 4.0, "delta+bf16": 2.0,
                     "delta+int8ef": 1.0}


def check_wire(wire: str) -> str:
    """Validate a wire-format name; returns it for chaining."""
    if wire not in WIRE_MODES:
        raise ValueError(f"wire must be one of {WIRE_MODES}, got {wire!r}")
    return wire


def wire_entry_bytes(wire: str, index_bits: int = 32,
                     width: int = 1) -> float:
    """Modeled on-wire bytes per sparse entry under ``wire``.

    ``index_bits`` is the packed offset width at the stage in question
    (32 for "raw", which always ships whole uint32 words); ``width`` is
    the value vector width.  The int8ef per-row scale word is amortized
    across the row and priced separately by ``modeled_time``.
    """
    check_wire(wire)
    if wire == "raw":
        index_bits = 32
    return index_bits / 8.0 + _WIRE_VALUE_BYTES[wire] * width


def _check_degrees(num_nodes: int, degrees: Sequence[int]) -> None:
    if math.prod(degrees) != num_nodes:
        raise ValueError(f"prod({list(degrees)}) != {num_nodes}")
    if any(k < 2 for k in degrees) and list(degrees) != [1]:
        raise ValueError(f"degrees must be >= 2, got {list(degrees)}")


@dataclasses.dataclass(frozen=True)
class ButterflyPlan:
    """Mixed-radix nested butterfly over ``num_nodes`` nodes."""

    num_nodes: int
    degrees: Tuple[int, ...]

    def __post_init__(self):
        if self.num_nodes == 1:
            object.__setattr__(self, "degrees", tuple())
            return
        _check_degrees(self.num_nodes, self.degrees)

    # -- mixed-radix structure -------------------------------------------------
    @property
    def depth(self) -> int:
        """Number of butterfly layers D (= len(degrees))."""
        return len(self.degrees)

    def strides(self) -> List[int]:
        """stride[l] = prod of degrees *below* layer l (digit 1 most significant)."""
        out, s = [], 1
        for k in reversed(self.degrees):
            out.append(s)
            s *= k
        return list(reversed(out))

    def digits(self, node: int) -> List[int]:
        """Mixed-radix digits of ``node``, one per layer (digit 1 first)."""
        out = []
        for k, s in zip(self.degrees, self.strides()):
            out.append((node // s) % k)
        return out

    def group_members(self, node: int, layer: int) -> List[int]:
        """The k_l nodes (incl. ``node``) differing only in digit ``layer``."""
        k, s = self.degrees[layer], self.strides()[layer]
        base = node - ((node // s) % k) * s
        return [base + t * s for t in range(k)]

    def axis_index_groups(self, layer: int) -> List[List[int]]:
        """Partition of [0, M) into layer-l groups (the stacked-mesh
        transport's exchange groups)."""
        seen, groups = set(), []
        for n in range(self.num_nodes):
            if n in seen:
                continue
            g = self.group_members(n, layer)
            groups.append(g)
            seen.update(g)
        return groups

    # -- range partition ---------------------------------------------------------
    def range_at(self, node: int, layer: int) -> Tuple[int, int]:
        """Hashed-space range owned by ``node`` *after* ``layer`` layers.

        layer=0 -> full space; layer=D -> the node's final 1/M slice.
        """
        lo, hi = 0, SPACE
        digs = self.digits(node)
        for l in range(layer):
            k = self.degrees[l]
            span = (hi - lo) // k
            new_lo = lo + digs[l] * span
            # last sub-range absorbs the division remainder so the ranges
            # tile exactly (matches edges_at, which pins e[-1] to hi)
            hi = new_lo + span if digs[l] < k - 1 else hi
            lo = new_lo
        return lo, hi

    def edges_at(self, node: int, layer: int) -> np.ndarray:
        """uint-64 range boundaries [k_l + 1] splitting node's layer-l range."""
        lo, hi = self.range_at(node, layer)
        k = self.degrees[layer]
        span = (hi - lo) // k
        e = lo + span * np.arange(k + 1, dtype=np.int64)
        e[-1] = hi
        return e

    def all_edges(self, layer: int) -> np.ndarray:
        """[M, k_l + 1] per-node range edges at ``layer`` (device backend)."""
        return np.stack([self.edges_at(n, layer) for n in range(self.num_nodes)])

    # -- packet-size / compression model (Fig 5) ---------------------------------
    def expected_counts(self, n0: float, total_range: float) -> List[float]:
        """E[#unique indices] held per node after each layer.

        n0 uniform-hashed indices per node over ``total_range`` ids.  Union of
        k Bernoulli(p) subsets has density 1-(1-p)^k.
        """
        counts = [float(n0)]
        r = float(total_range)
        for k in self.degrees:
            p = min(counts[-1] / r, 1.0)
            r_next = r / k
            counts.append(r_next * (1.0 - (1.0 - p) ** k))
            r = r_next
        return counts

    def index_bits_per_layer(self) -> List[int]:
        """Modeled packed-offset width (bits) of the delta wire codec at
        each layer: ``ceil(log2(span + 1))`` for the layer-l subrange span
        ``SPACE / prod(k_1..k_l)``.  Matches the codec's edge-derived
        widths exactly for power-of-2 meshes (remainder-free splits); off
        by at most one bit otherwise.
        """
        bits, r = [], float(SPACE)
        for k in self.degrees:
            r = r / k
            bits.append(max(1, min(32, int(math.ceil(math.log2(r + 1.0))))))
        return bits

    def _layer_entry_bytes(self, bytes_per_entry: float, wire: str,
                           value_width: int) -> List[float]:
        """Per-layer bytes/entry: the caller's raw ``bytes_per_entry``
        scaled by the wire format's compression ratio at that layer."""
        if wire == "raw":
            return [bytes_per_entry] * self.depth
        raw = wire_entry_bytes("raw", 32, value_width)
        return [bytes_per_entry * wire_entry_bytes(wire, b, value_width) / raw
                for b in self.index_bits_per_layer()]

    def packet_bytes(self, n0: float, total_range: float,
                     bytes_per_entry: float = 12.0,
                     wire: str = "raw", value_width: int = 1) -> List[float]:
        """Modeled per-destination message size at each down layer (Fig 5),
        post-encoding when ``wire`` != "raw"."""
        check_wire(wire)
        counts = self.expected_counts(n0, total_range)
        bpe = self._layer_entry_bytes(bytes_per_entry, wire, value_width)
        return [counts[l] / self.degrees[l] * bpe[l]
                for l in range(self.depth)]

    # -- cost model (Fig 6) --------------------------------------------------------
    def modeled_time(self, n0: float, total_range: float,
                     fabric: Fabric = EC2_2013, bytes_per_entry: float = 12.0,
                     merge_ns_per_entry: float = 4.0,
                     serial_nic: bool = True, wire: str = "raw",
                     value_width: int = 1) -> float:
        """End-to-end modeled config+reduce time (s) for one allreduce.

        ``wire`` prices the *encoded* payload (delta index packing shrinks
        the per-entry bytes layer by layer; lossy value modes narrow the
        value stream; int8ef adds one scale word per message).  Stage
        times — and thus the fabric's packet floor — are computed from the
        post-encoding sizes, so compression can push a message under the
        floor and stop paying bandwidth for it.  ``wire="raw"`` reproduces
        the original model exactly.
        """
        check_wire(wire)
        counts = self.expected_counts(n0, total_range)
        bpe = self._layer_entry_bytes(bytes_per_entry, wire, value_width)
        scale_overhead = 4.0 if wire == "delta+int8ef" else 0.0
        t = 0.0
        for l, k in enumerate(self.degrees):
            down_bytes = counts[l] / k * bpe[l] + scale_overhead
            t += fabric.stage_time(down_bytes, k - 1, serial=serial_nic)
            # received k-1 buckets + own; merge cost ~ entries * log2(k)
            t += counts[l] * max(math.log2(k), 1.0) * merge_ns_per_entry * 1e-9
        for l in reversed(range(self.depth)):
            k = self.degrees[l]
            # Each node returns to each peer only the piece that peer asked
            # for (~ what the peer sent down): counts[l]/k entries, values only.
            up_bytes = counts[l] / k * bpe[l] + scale_overhead
            t += fabric.stage_time(up_bytes, k - 1, serial=serial_nic)
        return t

    def modeled_overlap_time(self, n0: float, total_range: float,
                             fabric: Fabric = EC2_2013,
                             bytes_per_entry: float = 12.0,
                             merge_ns_per_entry: float = 4.0,
                             serial_nic: bool = True, wire: str = "raw",
                             value_width: int = 1,
                             hidden_compute_s: float = 0.0) -> float:
        """Modeled makespan (s) of one allreduce *plus* ``hidden_compute_s``
        of independent compute under an overlapped schedule.

        The overlapped schedules (the bucketed stage-major gradient sync of
        ``repro.train.step`` and the graph engine's rotated scan,
        ARCHITECTURE.md "Overlap & scheduling") issue each stage's payload
        transmission early and consume it late, so the *bandwidth* share of
        every stage can proceed concurrently with compute that does not
        depend on it.  Per-message setup + congestion and the local merges
        stay serial (``Fabric.stage_split``):

            t = serial_total + max(bandwidth_total, hidden_compute_s)

        With ``hidden_compute_s=0`` this equals :meth:`modeled_time`
        exactly (the splits are exact decompositions), so the synchronous
        comparator is ``modeled_time(...) + hidden_compute_s`` and the
        modeled overlap win is their difference.  ``select_plan`` reranks
        degree sequences under this term via ``overlap_compute_s``
        (``repro.core.autotune``; TUNING.md) — once bandwidth hides, the
        residual serial-NIC cost is per-message setup, ``sum(k_l - 1)``
        messages per node, so the optimum shifts toward deeper,
        lower-degree factorizations (binary in the limit) — the opposite
        of the bandwidth-bound direction (benchmarks/bench_overlap.py
        ``model_rerank`` rows chart the shift).
        """
        check_wire(wire)
        counts = self.expected_counts(n0, total_range)
        bpe = self._layer_entry_bytes(bytes_per_entry, wire, value_width)
        scale_overhead = 4.0 if wire == "delta+int8ef" else 0.0
        serial_t = 0.0
        bw_t = 0.0
        for l, k in enumerate(self.degrees):
            down_bytes = counts[l] / k * bpe[l] + scale_overhead
            lat, bw = fabric.stage_split(down_bytes, k - 1, serial=serial_nic)
            serial_t += lat + counts[l] * max(math.log2(k), 1.0) \
                * merge_ns_per_entry * 1e-9
            bw_t += bw
        for l in reversed(range(self.depth)):
            k = self.degrees[l]
            up_bytes = counts[l] / k * bpe[l] + scale_overhead
            lat, bw = fabric.stage_split(up_bytes, k - 1, serial=serial_nic)
            serial_t += lat
            bw_t += bw
        return serial_t + max(bw_t, float(hidden_compute_s))

    def __str__(self):
        return "x".join(str(k) for k in self.degrees) or "1"


# ---------------------------------------------------------------------------
# Degree-sequence enumeration + tuner (paper Fig 6: optimum 16x4 at M=64)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def ordered_factorizations(m: int, max_depth: int = 6) -> Tuple[Tuple[int, ...], ...]:
    """All ordered factorizations of m into factors >= 2, depth-limited.

    ``max_depth`` caps the sequence length to bound the sweep (the count of
    ordered factorizations grows super-polynomially).  The cap silently
    *excludes* factorizations needing more than ``max_depth`` factors —
    e.g. the full binary butterfly of ``m = 2**7`` at the default cap of 6.
    :func:`tune` detects that case (``Omega(m) > max_depth``, with Omega
    the number of prime factors counted with multiplicity) and re-runs the
    sweep with the cap lifted to ``Omega(m)`` so no shape is lost.
    """
    if m == 1:
        return ((),)
    out = []

    def rec(rem: int, prefix: Tuple[int, ...]):
        if rem == 1 and prefix:
            out.append(prefix)
            return
        if len(prefix) >= max_depth:
            return
        for k in range(2, rem + 1):
            if rem % k == 0:
                rec(rem // k, prefix + (k,))

    rec(m, ())
    return tuple(out)


def num_prime_factors(m: int) -> int:
    """Omega(m): prime factors counted with multiplicity (= the deepest
    possible butterfly over m nodes; 0 for m = 1)."""
    count, d = 0, 2
    while d * d <= m:
        while m % d == 0:
            m //= d
            count += 1
        d += 1
    return count + (1 if m > 1 else 0)


def tune(num_nodes: int, n0: float, total_range: float,
         fabric: Fabric = EC2_2013, bytes_per_entry: float = 12.0,
         serial_nic: bool = True, top: int = 0, max_depth: int = 6,
         wire: str = "raw", value_width: int = 1,
         hidden_compute_s: float = 0.0):
    """Rank all degree sequences by modeled time; return best (or top-n list).

    Model assumptions (documented, not measured; ``core.autotune`` fits
    the fabric to timings):

    * payload compression follows :meth:`ButterflyPlan.expected_counts` —
      i.e. per-node indices are uniform-hashed samples, the Bernoulli-union
      curve the paper derives for power-law data after hashing (§III-A);
    * stage cost is ``fabric.stage_time`` (alpha-beta-floor + gamma
      congestion) with ``serial_nic`` picking NIC serialization vs
      per-link overlap, and the local k-way merge costs
      ``entries * log2(k)`` at a fixed ns/entry;
    * with ``hidden_compute_s=0`` (default) stages are bulk-synchronous:
      no cross-stage overlap (paper Fig 7's threading gains are *not*
      modeled); ``hidden_compute_s > 0`` scores candidates with
      :meth:`ButterflyPlan.modeled_overlap_time` instead — the bandwidth
      share of every stage is hidden behind that much independent compute,
      which is how the overlapped schedules re-rank degrees.

    Degenerate sweeps degrade gracefully instead of silently returning the
    flat plan: if ``num_nodes`` is prime (or 1) the round-robin plan
    ``(num_nodes,)`` is the *only* factorization, and a ``UserWarning``
    says so; if ``max_depth`` would truncate the sweep (``Omega(num_nodes)
    > max_depth``) the cap is lifted to ``Omega`` with a ``UserWarning``
    so deep low-degree plans still compete.
    """
    omega = num_prime_factors(num_nodes)
    if omega > max_depth:
        warnings.warn(
            f"tune(num_nodes={num_nodes}): max_depth={max_depth} would "
            f"truncate the factorization sweep (deepest butterfly needs "
            f"{omega} layers); lifting the cap to {omega}", UserWarning,
            stacklevel=2)
        max_depth = omega
    facs = ordered_factorizations(num_nodes, max_depth)
    if num_nodes > 1 and len(facs) == 1:
        warnings.warn(
            f"tune(num_nodes={num_nodes}): prime node count has no "
            f"nontrivial factorization — falling back to the flat "
            f"round-robin plan ({num_nodes},)", UserWarning, stacklevel=2)
    check_wire(wire)
    scored = []
    for degs in facs:
        plan = ButterflyPlan(num_nodes, degs)
        if hidden_compute_s > 0.0:
            t = plan.modeled_overlap_time(
                n0, total_range, fabric, bytes_per_entry,
                serial_nic=serial_nic, wire=wire, value_width=value_width,
                hidden_compute_s=hidden_compute_s)
        else:
            t = plan.modeled_time(n0, total_range, fabric, bytes_per_entry,
                                  serial_nic=serial_nic, wire=wire,
                                  value_width=value_width)
        scored.append((t, plan))
    scored.sort(key=lambda x: x[0])
    if top:
        return scored[:top]
    return scored[0][1]


def roundrobin_plan(num_nodes: int) -> ButterflyPlan:
    """The degree-M single-stage plan (paper §II's round-robin corner)."""
    return ButterflyPlan(num_nodes, (num_nodes,)) if num_nodes > 1 else ButterflyPlan(1, ())


def binary_plan(num_nodes: int) -> ButterflyPlan:
    """The degree-2 full-depth plan (paper §II's binary-butterfly corner);
    requires a power-of-2 node count."""
    d = int(math.log2(num_nodes))
    if 2 ** d != num_nodes:
        raise ValueError(f"binary butterfly needs power-of-2 nodes, got {num_nodes}")
    return ButterflyPlan(num_nodes, (2,) * d)
