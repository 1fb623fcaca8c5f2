"""Planned Sparse Allreduce: host ``config``, stacked-mesh ``reduce`` (reference: ``repro.core.planned``).

The paper's property #2 (§I-B): index calculations are separated from
value calculations and computed once when the indices are fixed (e.g.
PageRank iterations).  ``config`` (:func:`plan_sparse_allreduce`) runs the
message-level routing once on the host (numpy, through the simulator's
data structures) and freezes every decision into static, padded
gather/scatter index tensors -- the same arrays, byte for byte, as the
reference's.  ``reduce`` is then gathers, stacked-mesh exchanges and
scatter-adds over all ``M`` nodes at once, reused every iteration with new
values.  An r-way replicated plan (paper §V) freezes the routing of all
``r * M`` physical replicas once; its ``weights`` (1 on each logical
shard's first alive replica, 0 elsewhere) multiply the values before the
first exchange, and :meth:`PlannedSparseAllreduce.with_dead` swaps them
for a new dead set without replanning.  :func:`planned_from_reference`
rebuilds a plan from the arrays the reference's plan cache stores, so a
plan frozen by the reference runs unchanged here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .allreduce import DevicePlan, make_device_plan
from .simulator import SimSparseAllreduce
from .sparse_vec import HashPerm
from .transport import StackedTransport, resolve_device


@dataclasses.dataclass
class _LayerMaps:
    send_gather: np.ndarray    # [M, k, cap]  -> positions in current values
    merge_scatter: np.ndarray  # [M, k, cap]  -> positions in next values (or m_max)
    merged_size: int           # m_max (+1 slot used as drop bin)
    up_send_gather: np.ndarray  # [M, k, upcap] -> positions in my up array
    up_recv_scatter: np.ndarray  # [M, k, upcap] -> positions in my (layer-l) up array
    up_size: int


@dataclasses.dataclass(frozen=True)
class _FixedOrderSum:
    """A scatter-add frozen into a fixed order (a segment layout).

    ``slots [M, ...]`` sends source ``(n, i)`` (flattened row-major) to
    slot ``slots[n, i]`` of node n's ``size`` outputs; slot ``size`` (the
    drop bin) and anything outside ``[0, size)`` is left out.  ``order``
    lists the kept sources grouped by destination, each group in
    increasing source position, and ``offsets`` ``[M * size + 1]`` where
    each group starts.  At reduce time one gather puts the values in that
    order and ``torch.segment_reduce`` adds each group from 0 in turn:
    the order a CPU ``index_add_`` adds in, with no float atomics, so the
    bits are the same on every run.  ``fan`` is the most sources any
    destination has (at most the degree for a merge scatter)."""
    order: torch.Tensor        # int64 [kept sources]
    offsets: torch.Tensor      # int64 [M * size + 1]
    rows: int                  # M * size
    fan: int

    @classmethod
    def build(cls, slots: np.ndarray, size: int, device) -> "_FixedOrderSum":
        """The layout of ``slots`` (int [M, ...]) for ``size`` slots a
        node, on ``device``."""
        m = slots.shape[0]
        s = slots.reshape(m, -1).astype(np.int64)
        keep = (s >= 0) & (s < size)
        dst = (s + (np.arange(m, dtype=np.int64) * size)[:, None])[keep]
        src = np.flatnonzero(keep)
        by_dst = np.argsort(dst, kind="stable")
        counts = np.bincount(dst, minlength=m * size)
        offsets = np.zeros(m * size + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        return cls(order=torch.as_tensor(src[by_dst], device=device),
                   offsets=torch.as_tensor(offsets, device=device),
                   rows=m * size, fan=int(counts.max(initial=0)))

    def __call__(self, src: torch.Tensor, wshape: Tuple[int, ...]
                 ) -> torch.Tensor:
        """``out [M * size, *wshape]``: each slot's sources of ``src``
        (``[M, ..., *wshape]``, flattened as ``slots``) summed in order."""
        width = int(np.prod(wshape, dtype=np.int64))
        if self.order.numel() == 0:
            return torch.zeros((self.rows,) + wshape, dtype=src.dtype,
                               device=src.device)
        picked = src.reshape(-1, width).index_select(0, self.order)
        # 2-D data: one thread per (segment, column), adding in order
        out = torch.segment_reduce(picked, "sum", offsets=self.offsets,
                                   axis=0, unsafe=True)
        return out.reshape((self.rows,) + wshape)


@dataclasses.dataclass(frozen=True)
class _DeviceRouting:
    """Frozen routing on one device, pre-flattened for the batched ops:
    gathers keep per-node positions (clamped, with a validity mask); the
    down half's scatters are :class:`_FixedOrderSum` layouts into
    flattened ``[M * size]`` buffers; the up half's scatters carry ``node
    * (size + 1) + slot`` offsets into ``[M * (size + 1)]`` buffers whose
    last slot per node is the drop bin."""
    user_scatter: _FixedOrderSum                # -> [M * sorted_size]
    layers: Tuple[Tuple[torch.Tensor, ...], ...]  # per layer, see _route_layer
    bottom_gather: torch.Tensor                 # [M, q_cap]
    bottom_hit: torch.Tensor                    # [M, q_cap] bool
    user_gather: torch.Tensor                   # [M, uin_cap]
    user_hit: torch.Tensor                      # [M, uin_cap] bool
    transport: StackedTransport
    weights: Optional[torch.Tensor] = None      # [M] f32, replicated plans


def _flat_offsets(slots: np.ndarray, size: int, device) -> torch.Tensor:
    """``node * (size + 1) + slot`` for slots [M, ...] in [0, size]."""
    m = slots.shape[0]
    base = (np.arange(m, dtype=np.int64) * (size + 1)).reshape(
        (m,) + (1,) * (slots.ndim - 1))
    return torch.as_tensor((slots.astype(np.int64) + base).reshape(-1),
                           device=device)


def _gather_pair(pos: np.ndarray, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(clamped positions [M, n], mask [M, n]) of a -1 padded gather table
    [M, ...] flattened to two dims."""
    p = pos.reshape(pos.shape[0], -1)
    return (torch.as_tensor(np.maximum(p, 0).astype(np.int64), device=device),
            torch.as_tensor(p >= 0, device=device))


def _rows_mask(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mask if x.ndim == mask.ndim else mask.unsqueeze(-1)


def _gather(x: torch.Tensor, pos: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``x[n, pos[n, i]]`` per node, zero where ``mask`` is False."""
    if x.ndim == 2:
        g = torch.gather(x, 1, pos)
    else:
        g = torch.gather(x, 1, pos.unsqueeze(-1).expand(pos.shape + x.shape[2:]))
    return torch.where(_rows_mask(mask, g), g, torch.zeros_like(g))


@dataclasses.dataclass
class PlannedSparseAllreduce:
    """Static-index sparse allreduce (the device backend of the port; the
    simulator analogue is ``SimSparseAllreduce``).

    Build with :func:`plan_sparse_allreduce` (the paper's ``config``), once
    per index pattern; afterwards everything is static and reusable:

    * :meth:`reduce_on_device` -- stacked values ``[M, u_cap(,W)]`` in,
      ``[M, uin_cap(,W)]`` out, as batched torch ops on one device;
    * :meth:`reduce_down_on_device` / :meth:`reduce_up_on_device` -- its
      two halves;
    * :meth:`make_reduce_fn` -- a bound callable for per-call use;
    * :meth:`device_args` -- the frozen routing tensors on a device, which
      the reduce methods take after the values.

    The value sums of the down half run in a fixed order, frozen with the
    routing (:class:`_FixedOrderSum`): each destination adds its sources
    in increasing source position, as a CPU ``index_add_`` does, with no
    float atomics, so a reduce gives the same bits on every run and on
    CPU and CUDA alike.

    ``weights`` (r-way replicated plans, or a ``dead`` set): ``[M]``
    per-physical-node contribution weights, applied to the values before
    the first exchange; None when not replicated.
    """

    dplan: DevicePlan
    perm: HashPerm
    width: int
    user_scatter: np.ndarray        # [M, u_cap] user slot -> sorted slot
    sorted_size: int
    layers: List[_LayerMaps]
    bottom_gather: np.ndarray       # [M, q_cap] positions into bottom values
    bottom_hit: np.ndarray          # [M, q_cap] bool
    user_gather: np.ndarray         # [M, uin_cap] sorted-in slot per user slot
    in_user_len: int
    weights: Optional[np.ndarray] = None
    _routing: Dict[str, _DeviceRouting] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    @property
    def u_cap(self) -> int:
        """Per-node *outbound* value capacity (``[M, u_cap(,W)]`` in)."""
        return int(self.user_scatter.shape[1])

    @property
    def uin_cap(self) -> int:
        """Per-node *inbound* capacity (``[M, uin_cap(,W)]`` out)."""
        return int(self.in_user_len)

    @property
    def depth(self) -> int:
        """Butterfly depth: each reduce runs ``depth`` down + ``depth`` up
        exchanges."""
        return len(self.layers)

    @property
    def q_cap(self) -> int:
        """Per-node *bottom* capacity: the root-layer partial sums between
        the two halves, ``[M, q_cap(,W)]``."""
        return int(self.bottom_gather.shape[1])

    # ---------------------------------------------------------------------
    def device_args(self, device=None) -> _DeviceRouting:
        """The frozen routing tensors on ``device`` (built once per device,
        then cached), with the stacked-mesh transport they run on."""
        device = resolve_device(device)
        key = str(device)
        hit = self._routing.get(key)
        if hit is not None:
            return hit
        layers = []
        for L in self.layers:
            sg, sm = _gather_pair(L.send_gather, device)
            ug, um = _gather_pair(L.up_send_gather, device)
            layers.append((sg, sm, _FixedOrderSum.build(
                               L.merge_scatter, L.merged_size, device),
                           ug, um, _flat_offsets(L.up_recv_scatter, L.up_size,
                                                 device)))
        bg, _ = _gather_pair(self.bottom_gather, device)
        ug, um = _gather_pair(self.user_gather, device)
        routing = _DeviceRouting(
            user_scatter=_FixedOrderSum.build(self.user_scatter,
                                              self.sorted_size, device),
            layers=tuple(layers), bottom_gather=bg,
            bottom_hit=torch.as_tensor(self.bottom_hit, device=device),
            user_gather=ug, user_hit=um,
            transport=StackedTransport(self.dplan.logical, device),
            weights=self._weights_on(device))
        self._routing[key] = routing
        return routing

    def _weights_on(self, device) -> Optional[torch.Tensor]:
        return (None if self.weights is None else
                torch.as_tensor(self.weights, dtype=torch.float32,
                                device=device))

    def with_dead(self, dead=None) -> "PlannedSparseAllreduce":
        """Incremental repair: the same frozen routing with a new dead set.
        Only the contribution weights depend on ``dead`` (every physical
        node receives the full union, paper §V), so this swaps them --
        here and in the routing already on each device -- and replans
        nothing.  Raises ``DeadLogicalNode`` when ``dead`` kills a whole
        replica group."""
        from .replication import contribution_weights
        weights = contribution_weights(self.dplan.num_nodes,
                                       self.dplan.replication, dead)
        out = dataclasses.replace(self, weights=weights, _routing={})
        for key, routing in self._routing.items():
            out._routing[key] = dataclasses.replace(
                routing, weights=out._weights_on(routing.transport.device))
        return out

    # ---------------------------------------------------------------------
    def reduce_on_device(self, values: torch.Tensor,
                         routing: Optional[_DeviceRouting] = None) -> torch.Tensor:
        """Stacked values [M, u_cap(,W)] -> [M, uin_cap(,W)]: the down half
        then the up half, ``2 * depth`` exchanges in all."""
        routing = routing or self.device_args(values.device)
        return self.reduce_up_on_device(
            self.reduce_down_on_device(values, routing), routing)

    def reduce_down_on_device(self, values: torch.Tensor,
                              routing: Optional[_DeviceRouting] = None
                              ) -> torch.Tensor:
        """Bottom half: user values ``[M, u_cap(,W)]`` -> root-layer partial
        sums ``[M, q_cap(,W)]`` (``depth`` down exchanges, each followed
        by a scatter-add merge)."""
        routing = routing or self.device_args(values.device)
        m = values.shape[0]
        wshape = values.shape[2:]
        if routing.weights is not None:
            # replica contribution weight, one per physical node (paper §V)
            values = values * routing.weights.to(values.dtype).reshape(
                (m,) + (1,) * (values.ndim - 1))

        # coalesce user values onto sorted slots (padding: the drop bin)
        cur = routing.user_scatter(values, wshape).reshape(
            (m, self.sorted_size) + wshape)
        for l, L in enumerate(self.layers):
            send_g, send_m, merge_s = routing.layers[l][:3]
            k, cap = L.send_gather.shape[1], L.send_gather.shape[2]
            picked = _gather(cur, send_g, send_m).reshape((m, k, cap) + wshape)
            (recv,) = routing.transport.all_to_all(l, picked)
            cur = merge_s(recv, wshape).reshape((m, L.merged_size) + wshape)
        return _gather(cur, routing.bottom_gather, routing.bottom_hit)

    def reduce_up_on_device(self, up: torch.Tensor,
                            routing: Optional[_DeviceRouting] = None
                            ) -> torch.Tensor:
        """Top half: root-layer partials ``[M, q_cap(,W)]`` -> requested
        values ``[M, uin_cap(,W)]`` (``depth`` up exchanges in reverse
        layer order + the final user gather)."""
        routing = routing or self.device_args(up.device)
        m = up.shape[0]
        wshape = up.shape[2:]
        for l in reversed(range(len(self.layers))):
            L = self.layers[l]
            up_g, up_m, up_s = routing.layers[l][3:]
            k, cap = L.up_send_gather.shape[1], L.up_send_gather.shape[2]
            picked = _gather(up, up_g, up_m).reshape((m, k, cap) + wshape)
            (recv,) = routing.transport.all_to_all(l, picked)
            nxt = torch.zeros((m * (L.up_size + 1),) + wshape, dtype=up.dtype,
                              device=up.device)
            nxt.index_copy_(0, up_s, recv.reshape((-1,) + wshape))
            up = nxt.reshape((m, L.up_size + 1) + wshape)[:, :L.up_size]
        return _gather(up, routing.user_gather, routing.user_hit)

    # ---------------------------------------------------------------------
    def make_reduce_fn(self, device=None):
        """Bound entry: values [M, u_cap(,W)] -> [M, uin_cap(,W)] on
        ``device`` (inputs are moved there)."""
        routing = self.device_args(device)
        dev = routing.transport.device

        def run(values: torch.Tensor) -> torch.Tensor:
            return self.reduce_on_device(torch.as_tensor(values, device=dev),
                                         routing)

        return run


# ---------------------------------------------------------------------------
# config: run host routing once, freeze into padded tensors
# ---------------------------------------------------------------------------

def plan_sparse_allreduce(dplan: DevicePlan,
                          out_indices: Sequence[np.ndarray],
                          in_indices: Sequence[np.ndarray],
                          perm: Optional[HashPerm] = None,
                          width: int = 1,
                          dead=None) -> PlannedSparseAllreduce:
    """The paper's ``config`` call: indices in, frozen routing out (the
    reference's host numpy, unchanged).

    For an r-way replicated ``dplan`` (``make_device_plan(replication=
    r)``) ``out_indices`` / ``in_indices`` are the *logical* per-shard
    lists (``dplan.num_logical`` of them); the routing is frozen for all
    physical replicas, and the ``dead`` physical ids are masked by the
    plan's ``weights`` (``contribution_weights``).  Raises
    ``DeadLogicalNode`` when a whole replica group is dead -- with r = 1,
    for any dead node."""
    perm = perm if perm is not None else HashPerm.make(0)
    weights = None
    if dplan.replication > 1 or dead:
        from .replication import contribution_weights
        weights = contribution_weights(dplan.num_nodes, dplan.replication,
                                       dead)
        if len(out_indices) != dplan.num_logical:
            raise ValueError(
                f"replicated plan expects {dplan.num_logical} logical index "
                f"lists, got {len(out_indices)}")
        out_indices = list(out_indices) * dplan.replication
        in_indices = list(in_indices) * dplan.replication
    sim = SimSparseAllreduce(dplan.logical, perm=perm, value_width=width)
    sim.config(out_indices, in_indices)
    plan, m = dplan.logical, dplan.logical.num_nodes
    didx = sim._down_idx_cache  # per-layer sorted idx arrays

    u_cap = max(len(u) for u in sim.out_user_to_sorted) or 1
    sorted_size = max(len(s) for s in sim.out_sorted) or 1
    user_scatter = np.full((m, u_cap), sorted_size, np.int32)  # drop bin
    for n in range(m):
        user_scatter[n, : len(sim.out_user_to_sorted[n])] = \
            sim.out_user_to_sorted[n]

    layers: List[_LayerMaps] = []
    for l in range(plan.depth):
        k = plan.degrees[l]
        cap = 0
        cuts_all = []
        for n in range(m):
            cuts = np.searchsorted(didx[l][n].astype(np.uint64),
                                   plan.edges_at(n, l).astype(np.uint64))
            cuts_all.append(cuts)
            cap = max(cap, int(np.max(cuts[1:] - cuts[:-1])))
        merged_size = max(len(didx[l + 1][n]) for n in range(m)) or 1
        send_gather = np.full((m, k, cap), -1, np.int32)
        merge_scatter = np.full((m, k, cap), merged_size, np.int32)
        for n in range(m):
            cuts = cuts_all[n]
            for t in range(k):
                ln = cuts[t + 1] - cuts[t]
                send_gather[n, t, :ln] = np.arange(cuts[t], cuts[t + 1])
            # merge: received piece from member with digit t = that member's
            # slice at t_self; its position in my merged array = inv map
            src_slices, inv, uniq = sim.down_maps[l][n]
            for t in range(k):
                seg = inv[src_slices[t]:src_slices[t + 1]]
                merge_scatter[n, t, : len(seg)] = seg
        upcap = 0
        for n in range(m):
            for t in range(k):
                upcap = max(upcap, len(sim.ret_pos[l][n][t]))
        upcap = max(upcap, 1)
        up_size = max(len(sim.in_at[l][n]) for n in range(m)) or 1
        up_send_gather = np.full((m, k, upcap), -1, np.int32)
        up_recv_scatter = np.full((m, k, upcap), up_size, np.int32)
        for n in range(m):
            members = plan.group_members(n, l)
            t_self = members.index(n)
            # as sender: to peer with digit t, send values for that peer's
            # request piece, positions in MY layer-(l+1) up array
            for t, mem in enumerate(members):
                pos = sim.ret_pos[l][mem][t_self]
                up_send_gather[n, t, : len(pos)] = pos
            # as receiver: piece from member with digit t lands at my cuts
            own_idx = sim.in_at[l][n]
            cuts = np.searchsorted(own_idx.astype(np.uint64),
                                   plan.edges_at(n, l).astype(np.uint64))
            for t in range(k):
                ln = cuts[t + 1] - cuts[t]
                up_recv_scatter[n, t, :ln] = np.arange(cuts[t], cuts[t + 1])
        layers.append(_LayerMaps(send_gather=send_gather,
                                 merge_scatter=merge_scatter,
                                 merged_size=merged_size,
                                 up_send_gather=up_send_gather,
                                 up_recv_scatter=up_recv_scatter,
                                 up_size=up_size))

    q_cap = max(len(p) for p in sim.bottom_pos) or 1
    bottom_gather = np.full((m, q_cap), -1, np.int32)
    bottom_hit = np.zeros((m, q_cap), bool)
    for n in range(m):
        bottom_gather[n, : len(sim.bottom_pos[n])] = sim.bottom_pos[n]
        bottom_hit[n, : len(sim.bottom_hit[n])] = sim.bottom_hit[n]

    uin_cap = max(len(u) for u in sim.in_sorted_to_user) or 1
    user_gather = np.full((m, uin_cap), -1, np.int32)
    for n in range(m):
        user_gather[n, : len(sim.in_sorted_to_user[n])] = \
            sim.in_sorted_to_user[n]

    return PlannedSparseAllreduce(
        dplan=dplan, perm=perm, width=width,
        user_scatter=user_scatter, sorted_size=sorted_size, layers=layers,
        bottom_gather=bottom_gather, bottom_hit=bottom_hit,
        user_gather=user_gather, in_user_len=uin_cap, weights=weights)


def planned_from_reference(arrays: Dict[str, np.ndarray], meta: dict,
                           degrees_per_axis: Dict[str, Tuple[int, ...]],
                           device=None) -> PlannedSparseAllreduce:
    """Rebuild a plan from exactly the numpy ``(arrays, meta)`` that the
    reference's ``autotune.planned_to_artifact`` emits (its plan-cache
    entry), so a plan frozen by the reference runs unchanged in the port.

    ``degrees_per_axis`` is the *logical* per-axis degree dict of the
    original ``make_device_plan`` call (its replication comes from the
    artifact, as do the contribution ``weights`` of a replicated plan or
    one frozen with a dead set).  With ``device`` given, the routing
    tensors are moved there at once.
    """
    dmeta = meta["dplan"]
    dplan = make_device_plan(
        [(a, int(s)) for a, s in dmeta["axes"]],
        {a: tuple(int(x) for x in d) for a, d in degrees_per_axis.items()},
        in_capacity=int(dmeta["in_capacity"]),
        out_capacity=int(dmeta["out_capacity"]),
        replication=int(dmeta["replication"]))
    layers = [_LayerMaps(
        send_gather=np.asarray(arrays[f"layer{i}/send_gather"]),
        merge_scatter=np.asarray(arrays[f"layer{i}/merge_scatter"]),
        merged_size=int(lm["merged_size"]),
        up_send_gather=np.asarray(arrays[f"layer{i}/up_send_gather"]),
        up_recv_scatter=np.asarray(arrays[f"layer{i}/up_recv_scatter"]),
        up_size=int(lm["up_size"])) for i, lm in enumerate(meta["layers"])]
    planned = PlannedSparseAllreduce(
        dplan=dplan,
        perm=HashPerm(mult=int(meta["perm"]["mult"]),
                      xor=int(meta["perm"]["xor"])),
        width=int(meta["width"]),
        user_scatter=np.asarray(arrays["user_scatter"]),
        sorted_size=int(meta["sorted_size"]),
        layers=layers,
        bottom_gather=np.asarray(arrays["bottom_gather"]),
        bottom_hit=np.asarray(arrays["bottom_hit"]),
        user_gather=np.asarray(arrays["user_gather"]),
        in_user_len=int(meta["in_user_len"]),
        weights=(np.asarray(arrays["weights"], np.float32)
                 if "weights" in arrays else None))
    if device is not None:
        planned.device_args(device)
    return planned
