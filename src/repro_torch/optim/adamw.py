"""AdamW with global-norm clipping (reference: ``repro.optim.adamw``).

State is ``AdamWState(step, m, v)``: an int32 step count and float32
moment trees mirroring the parameters.  The update is the reference's,
op for op in float32: gradients scaled by ``min(1, clip / max(gnorm,
1e-9))``, bias corrections ``1 - b ** step`` with the step as float32,
decay on leaves with ``ndim >= 2`` only (the period-stacked leaves count
their period dim, as in the reference), and the new parameters cast back
to their dtype.  Updates return new tensors; nothing is changed in
place.  Each leaf is updated in slices of its leading dim (at most
``SLICE_ELEMS`` elements), so the float32 temporaries of a
multi-gigabyte leaf stay small; the update is elementwise, so the slices
give the bits of one whole-leaf pass.  ``donate=True`` (the reference's
buffer donation) drops each old parameter, gradient and moment from its
tree as its replacement is made, so the update holds one set of moments.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

SLICE_ELEMS = 1 << 26


class AdamWState(NamedTuple):
    """Step count and first / second moments."""
    step: torch.Tensor
    m: Any
    v: Any


def _map(fn, *trees):
    """``fn`` over the leaves of dict trees of the same structure."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _paths(tree, prefix=()):
    """Leaf paths of a dict tree in sorted order."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _paths(tree[k], prefix + (k,))]
    return [prefix]


def _parent(tree, path):
    for k in path[:-1]:
        tree = tree[k]
    return tree


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


@dataclasses.dataclass(frozen=True)
class AdamW:
    """The reference's hyperparameters and defaults."""
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params) -> AdamWState:
        """Zero moments in float32 on each parameter's device."""
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        leaf = _leaves(params)[0]
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=leaf.device),
            m=_map(zeros, params), v=_map(zeros, params))

    def update(self, grads, state: AdamWState, params,
               gnorm: Optional[torch.Tensor] = None, donate: bool = False):
        """``(new_params, new_state, gnorm)``; ``gnorm`` defaults to the
        global norm of ``grads`` summed leaf by leaf in sorted-path
        order.  ``donate=True`` empties ``params``, ``grads``, ``state.m``
        and ``state.v`` leaf by leaf (the caller must not read them
        after)."""
        step = state.step + 1
        if gnorm is None:
            sq = torch.zeros((), dtype=torch.float32, device=step.device)
            for g in _leaves(grads):
                sq = sq + torch.sum(torch.square(g.to(torch.float32)))
            gnorm = torch.sqrt(sq)
        scale = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        stepf = step.to(torch.float32)
        b1c = 1.0 - torch.tensor(self.b1, dtype=torch.float32,
                                 device=step.device) ** stepf
        b2c = 1.0 - torch.tensor(self.b2, dtype=torch.float32,
                                 device=step.device) ** stepf

        def upd(p, g, m, v, decay):
            g = g.to(torch.float32) * scale
            m = self.b1 * m + (1 - self.b1) * g
            v = self.b2 * v + (1 - self.b2) * g * g
            mh = m / b1c
            vh = v / b2c
            delta = mh / (torch.sqrt(vh) + self.eps)
            if decay:
                delta = delta + self.weight_decay * p.to(torch.float32)
            return ((p.to(torch.float32) - self.lr * delta).to(p.dtype), m, v)

        new_p, new_m, new_v = {}, {}, {}
        for path in _paths(params):
            trees = (params, grads, state.m, state.v)
            p, g, m, v = (_parent(t, path)[path[-1]] for t in trees)
            if donate:
                for t in trees:
                    del _parent(t, path)[path[-1]]
            outs = (torch.empty_like(p), torch.empty_like(m),
                    torch.empty_like(v))
            rows = p.shape[0] if p.ndim else 1
            per = max(1, SLICE_ELEMS // max(1, p.numel() // max(rows, 1)))
            for lo in range(0, rows, per):
                sl = slice(lo, lo + per) if p.ndim else ...
                for o, r in zip(outs, upd(p[sl], g[sl], m[sl], v[sl],
                                          p.ndim >= 2)):
                    o[sl] = r
            del p, g, m, v
            for tree, o in zip((new_p, new_m, new_v), outs):
                _put(tree, path, o)
        return new_p, AdamWState(step=step, m=new_m, v=new_v), gnorm
