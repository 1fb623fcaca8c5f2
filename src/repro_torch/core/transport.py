"""Stacked-mesh transport: the butterfly's exchanges on one device (no reference counterpart).

The reference runs one program per device under ``shard_map`` and moves
data with ``lax.all_to_all`` / ``lax.all_gather`` inside each stage's
``axis_index_groups``.  The port's first transport keeps all ``M`` logical
nodes on one device as one tensor with a leading ``[M]`` axis.  Inside a
stage's groups both collectives only move rows, so each is a fixed index
permutation of the stacked tensor, precomputed once per stage:

* ``all_to_all`` of ``[M, k, ...]`` (split and concat on the k axis):
  node n at position j of its group receives, as row t, row j of the
  group member at position t;
* tiled ``all_gather`` of ``[M, C, ...]``: node n receives the
  concatenation of its group members' rows, in group order, as
  ``[k*C, ...]``.

Results are therefore bit for bit those of the reference's collectives.
The dense
butterfly's tiled ``reduce_scatter`` is a gather of each member's chunk
and a sum of them in member order.  An exchange moves each tensor in its
own dtype (int32 packed words, bf16 or int8 values, f32 scales), and
``calls`` counts exchanges (one per call,
however many tensors it moves), so a test can hold a reduce to its
``2 * depth`` exchanges.  :meth:`StackedTransport.position` is each
node's position in its stage group, the reference's ``(axis_index //
stride) % degree``, which a receiver of the wire codecs needs to find its
subrange base.

:meth:`StackedTransport.psum` is the whole-mesh sum that the reference
runs as ``lax.psum`` over the mesh axis (spectral's Rayleigh norm): a
pairwise tree over the node axis in one fixed order, broadcast back to
every node, so repeats give the same bits on any device.  It is counted
in ``sums``, apart from ``calls``, so a reduce still costs exactly ``2 *
depth`` exchanges.  Over a mesh of several data axes (``pod``, then
``data``) it sums one axis after another, as the reference's ``psum``
per axis does.  :meth:`StackedTransport.pmax` is the reference's
``lax.pmax`` by the same tree (the split-KV decode's softmax maximum),
counted in ``maxes``.

The model axis is a second stacked axis.  On a (data, model) mesh of dp x
tp positions, position n = d * tp + m (the device order of
``jax.make_mesh((dp, tp), ("data", "model"))``).  A data-axis plan
exchanges within each model column: ``StackedTransport(plan, device,
columns=tp)`` stacks dp * tp positions, and each stage group of data
node d becomes tp groups, one per column m, so one exchange (and one
merge launch) serves every column.  :class:`ModelAxis` is the model
axis within each data row: ``all_to_all`` and the tiled ``all_gather``
(index permutations, counted in ``calls``), what the MoE exchanges.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import obs

from .topology import ButterflyPlan


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    current CUDA device.  Raises when no CUDA device is present and none
    was named -- the port never falls back to the CPU silently."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


class StackedTransport:
    """Group exchanges of a butterfly over stacked ``[M, ...]`` tensors.

    Built once per (plan, device): for every layer l of ``plan`` it holds
    the all_to_all row permutation (``[M*k]``), the all_gather row table
    (``[M*k]``) and each node's group position (``[M]``) on ``device``.
    ``columns=tp`` stacks ``plan.num_nodes * tp`` positions, position
    ``d * tp + m`` being data node d of model column m: the plan's groups
    apply within each column (M counts every position).
    """

    def __init__(self, plan: ButterflyPlan, device=None, columns: int = 1):
        self.plan = plan
        self.columns = int(columns)
        self.device = resolve_device(device)
        self.calls = 0
        self.sums = 0
        self.maxes = 0
        tp = self.columns
        m = plan.num_nodes * tp
        col = np.arange(m, dtype=np.int64) % tp
        self._a2a, self._gather, self._position = [], [], []
        for l in range(plan.depth):
            k = plan.degrees[l]
            members = np.array([plan.group_members(n // tp, l)
                                for n in range(m)], np.int64) * tp \
                + col[:, None]                                 # [M, k]
            digit = np.array([plan.digits(n // tp)[l] for n in range(m)],
                             np.int64)
            self._a2a.append(torch.as_tensor(
                (members * k + digit[:, None]).reshape(-1), device=self.device))
            self._gather.append(torch.as_tensor(members.reshape(-1),
                                                device=self.device))
            self._position.append(torch.as_tensor(digit, device=self.device))
        # the tables: three host-to-device copies a layer (a union reduce's
        # plan-cache miss makes a transport)
        obs.count_htod("union.htod_copies", self.device, 3 * plan.depth)

    @property
    def num_nodes(self) -> int:
        """Stacked position count M (data nodes times columns)."""
        return self.plan.num_nodes * self.columns

    def position(self, layer: int) -> torch.Tensor:
        """int64 [M]: each node's position j in its layer-``layer`` group
        (digit ``layer`` of its node id, most-significant first)."""
        return self._position[layer]

    def all_to_all(self, layer: int, *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Group all_to_all of layer ``layer`` on each ``[M, k, ...]``
        tensor in ``xs`` (one exchange): ``out[n, t] = x[g_t(n), j(n)]``
        with ``g_t(n)`` the member at position t of n's group and ``j(n)``
        n's own position."""
        self.calls += 1
        perm = self._a2a[layer]
        return tuple(x.reshape((-1,) + x.shape[2:]).index_select(0, perm)
                     .reshape(x.shape) for x in xs)

    def all_gather(self, layer: int, *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Tiled group all_gather of layer ``layer`` on each ``[M, C, ...]``
        tensor in ``xs`` (one exchange): ``out[n] = concat_t x[g_t(n)]``,
        ``[M, k*C, ...]``."""
        self.calls += 1
        rows = self._gather[layer]
        m, k = self.num_nodes, self.plan.degrees[layer]
        return tuple(x.index_select(0, rows).reshape(
            (m, k * x.shape[1]) + x.shape[2:]) for x in xs)

    def reduce_scatter(self, layer: int, x: torch.Tensor) -> torch.Tensor:
        """Tiled group reduce-scatter of layer ``layer`` (the reference's
        ``lax.psum_scatter(..., tiled=True)``) on a ``[M, n, ...]`` tensor
        with n divisible by the degree k (one exchange): node n at group
        position j receives ``sum_t x[g_t(n)]`` over chunk j of size n / k,
        the k members' chunks added in member order, ``[M, n / k, ...]``."""
        self.calls += 1
        m, k = self.num_nodes, self.plan.degrees[layer]
        if x.shape[0] != m or x.shape[1] % k:
            raise ValueError(f"reduce_scatter: [{m}, n] with n divisible by "
                             f"{k} expected, got {tuple(x.shape)}")
        c = x.shape[1] // k
        rows = x.reshape((m * k, c) + x.shape[2:])
        src = self._a2a[layer].view(m, k)      # member t's chunk j(n)
        out = rows.index_select(0, src[:, 0])
        for t in range(1, k):
            out += rows.index_select(0, src[:, t])
        return out

    def psum(self, x: torch.Tensor, axes: Optional[Tuple[int, ...]] = None
             ) -> torch.Tensor:
        """Whole-mesh sum of a per-node ``[M, ...]`` tensor, broadcast
        back to ``[M, ...]``: the nodes are added pairwise in a tree of
        ceil(log2 M) levels (at each level node 2i + 1 into node 2i, an
        odd last node carried up unchanged), the same order every call.
        ``axes`` (sizes whose product is M, the mesh's axes in row-major
        order) sums one axis after another, first to last, each by that
        tree within its groups, as the reference's ``psum`` over each
        data axis in turn; each axis counts one sum.  (A whole-mesh sum:
        a transport with ``columns`` > 1 has none.)"""
        self.sums += len(self._axes(x, axes))
        return self._tree(x, axes, torch.add)

    def pmax(self, x: torch.Tensor, axes: Optional[Tuple[int, ...]] = None
             ) -> torch.Tensor:
        """Whole-mesh maximum of a per-node ``[M, ...]`` tensor (the
        reference's ``lax.pmax``), broadcast back: the tree and axis order
        of :meth:`psum`, each axis counted in ``maxes``."""
        self.maxes += len(self._axes(x, axes))
        return self._tree(x, axes, torch.maximum)

    def _axes(self, x: torch.Tensor, axes) -> Tuple[int, ...]:
        sizes = (self.num_nodes,) if axes is None else tuple(axes)
        if self.columns != 1 or x.shape[0] != self.num_nodes \
                or int(np.prod(sizes)) != self.num_nodes:
            raise ValueError(f"psum: expected {self.num_nodes} nodes of one "
                             f"column over axes {sizes}, got {x.shape[0]} "
                             f"of {self.columns}")
        return sizes

    def _tree(self, x: torch.Tensor, axes, op) -> torch.Tensor:
        """``op`` over the node axis pairwise in the fixed tree order of
        :meth:`psum`, one axis of ``axes`` after another."""
        sizes = self._axes(x, axes)
        s = x.reshape(sizes + tuple(x.shape[1:]))
        for a in range(len(sizes)):
            s = s.movedim(a, 0)
            while s.shape[0] > 1:
                n = s.shape[0]
                pair = op(s[0:n - 1:2], s[1:n:2])
                s = torch.cat([pair, s[n - 1:]]) if n % 2 else pair
            s = s.movedim(0, a)
        return s.reshape((1,) + tuple(x.shape[1:])).expand(
            x.shape).contiguous()


class ModelAxis:
    """The model axis of a stacked (data, model) mesh, within each data
    row: ``tp`` positions, position m of data row d being mesh position d
    * tp + m.

    Tensors over the axis are ``[dp, tp, ...]``.  ``all_to_all`` and the
    tiled ``all_gather`` are the reference's collectives over ``model``
    as index permutations, counted in ``calls``, apart from the data
    axis's transports.  The reference's ``psum`` / ``pmax`` over
    ``model`` have no counterpart: the models hold every leaf whole and
    take the summed product once (``repro_torch.models.common``)."""

    def __init__(self, tp: int):
        self.tp = int(tp)
        self.calls = 0

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.all_to_all(split_axis=0, concat_axis=0)`` over the model
        axis of per-position buffers ``[dp, tp, tp, ...]`` (position m's
        buffer t goes to position t): ``out[d, t, s] = x[d, s, t]``, so
        position t receives the buffers for it in source order."""
        self.calls += 1
        if x.shape[1] != self.tp or x.shape[2] != self.tp:
            raise ValueError(f"all_to_all: [dp, {self.tp}, {self.tp}, ...] "
                             f"expected, got {tuple(x.shape)}")
        return x.transpose(1, 2)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Tiled ``lax.all_gather`` over the model axis of ``[dp, tp, C,
        ...]``: the positions' rows laid end to end, ``[dp, tp * C, ...]``
        (what every position of the row receives)."""
        self.calls += 1
        if x.shape[1] != self.tp:
            raise ValueError(f"all_gather: [dp, {self.tp}, ...] expected, "
                             f"got {tuple(x.shape)}")
        return x.reshape((x.shape[0], self.tp * x.shape[2])
                         + tuple(x.shape[3:]))


def as_index_tensor(idx, device: Optional[torch.device] = None) -> torch.Tensor:
    """Hashed indices (uint32 numpy or an integer tensor) as the port's
    int64 tensor on ``device``."""
    if isinstance(idx, torch.Tensor):
        return idx.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(idx).astype(np.int64), device=device)
