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
``calls`` counts exchanges (one per call, however many tensors it moves),
so a test can hold a reduce to its ``2 * depth`` exchanges.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

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
    the all_to_all row permutation (``[M*k]``) and the all_gather row
    table (``[M*k]``) on ``device``.
    """

    def __init__(self, plan: ButterflyPlan, device=None):
        self.plan = plan
        self.device = resolve_device(device)
        self.calls = 0
        m = plan.num_nodes
        self._a2a, self._gather = [], []
        for l in range(plan.depth):
            k = plan.degrees[l]
            members = np.array([plan.group_members(n, l) for n in range(m)],
                               np.int64)                       # [M, k]
            digit = np.array([plan.digits(n)[l] for n in range(m)], np.int64)
            self._a2a.append(torch.as_tensor(
                (members * k + digit[:, None]).reshape(-1), device=self.device))
            self._gather.append(torch.as_tensor(members.reshape(-1),
                                                device=self.device))

    @property
    def num_nodes(self) -> int:
        """Stacked node count M."""
        return self.plan.num_nodes

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


def as_index_tensor(idx, device: Optional[torch.device] = None) -> torch.Tensor:
    """Hashed indices (uint32 numpy or an integer tensor) as the port's
    int64 tensor on ``device``."""
    if isinstance(idx, torch.Tensor):
        return idx.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(idx).astype(np.int64), device=device)
