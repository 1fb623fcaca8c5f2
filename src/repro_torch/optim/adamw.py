"""AdamW with global-norm clipping (reference: ``repro.optim.adamw``).

State is ``AdamWState(step, m, v)``: an int32 step count and float32
moment trees mirroring the parameters.  The update is the reference's,
op for op in float32: gradients scaled by ``min(1, clip / max(gnorm,
1e-9))``, bias corrections ``1 - b ** step`` with the step as float32,
decay on leaves with ``ndim >= 2`` only (the period-stacked leaves count
their period dim, as in the reference), and the new parameters cast back
to their dtype.  Updates return new tensors; nothing is changed in
place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch


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
               gnorm: Optional[torch.Tensor] = None):
        """``(new_params, new_state, gnorm)``; ``gnorm`` defaults to the
        global norm of ``grads`` summed leaf by leaf in sorted-path
        order."""
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

        def upd(p, g, m, v):
            g = g.to(torch.float32) * scale
            m = self.b1 * m + (1 - self.b1) * g
            v = self.b2 * v + (1 - self.b2) * g * g
            mh = m / b1c
            vh = v / b2c
            delta = mh / (torch.sqrt(vh) + self.eps)
            if p.ndim >= 2:
                delta = delta + self.weight_decay * p.to(torch.float32)
            return ((p.to(torch.float32) - self.lr * delta).to(p.dtype), m, v)

        trip = _map(upd, params, grads, state.m, state.v)
        new_p, new_m, new_v = (_map(lambda t, i=i: t[i], trip)
                               for i in range(3))
        return new_p, AdamWState(step=step, m=new_m, v=new_v), gnorm
