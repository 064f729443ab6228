"""Adam and SGD in the reference's functional form (port of
``repro/optim/adam.py``).

The parameters are a sequence of tensors (``list(module.parameters())``);
``update`` returns one update a parameter and the new state, and
``apply_updates`` adds them in place.  The arithmetic keeps the
reference's expression order, so a loss curve follows the reference's:
float32 moments, the bias corrections ``1 - b ** step`` in float32, the
step ``(m / bc1) / (sqrt(v / bc2) + eps)``, and the global-norm scale
``min(1, max_norm / max(norm, 1e-9))``.  ``torch.optim.Adam`` and
``clip_grad_norm_`` place eps, the bias correction and the clip's
epsilon differently.  The step count and the learning rate are host
scalars, so an update never waits on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Schedule = Union[float, Callable[[int], np.float32]]


class AdamState(NamedTuple):
    step: int
    m: List[torch.Tensor]
    v: List[torch.Tensor]


def _lr_at(lr: Schedule, step: int) -> np.float32:
    return np.float32(lr(step) if callable(lr) else lr)


def _zeros(params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in params]


@dataclasses.dataclass(frozen=True)
class Adam:
    lr: Schedule = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: Optional[float] = None

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        return AdamState(0, _zeros(params), _zeros(params))

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: AdamState,
               params: Sequence[torch.Tensor]
               ) -> Tuple[List[torch.Tensor], AdamState]:
        if self.grad_clip is not None:
            grads = clip_by_global_norm(grads, self.grad_clip)
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        m = [b1 * mm + (1 - b1) * g.float() for mm, g in zip(state.m, grads)]
        v = [b2 * vv + (1 - b2) * torch.square(g.float())
             for vv, g in zip(state.v, grads)]
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(step))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(step))
        neg_lr = float(-_lr_at(self.lr, step))
        updates = []
        for mm, vv, p in zip(m, v, params):
            u = (mm / bc1) / (torch.sqrt(vv / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            updates.append((neg_lr * u).to(p.dtype))
        return updates, AdamState(step, m, v)


@dataclasses.dataclass(frozen=True)
class Sgd:
    lr: Schedule = 1e-2
    momentum: float = 0.0

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        z = _zeros(params)
        return AdamState(0, z, z)

    @torch.no_grad()
    def update(self, grads, state: AdamState, params):
        step = state.step + 1
        neg_lr = float(-_lr_at(self.lr, step))
        if self.momentum:
            m = [self.momentum * mm + g.float()
                 for mm, g in zip(state.m, grads)]
            return ([(neg_lr * mm).to(p.dtype) for mm, p in zip(m, params)],
                    AdamState(step, m, state.v))
        return ([(neg_lr * g.float()).to(p.dtype)
                 for g, p in zip(grads, params)],
                AdamState(step, state.m, state.v))


@torch.no_grad()
def apply_updates(params: Sequence[torch.Tensor],
                  updates: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """``p + u`` for every parameter, in place; returns ``params``."""
    for p, u in zip(params, updates):
        p.add_(u.to(p.dtype))
    return params


@torch.no_grad()
def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float
                        ) -> List[torch.Tensor]:
    sq = sum(torch.sum(torch.square(g.float())) for g in grads)
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return [(g.float() * scale).to(g.dtype) for g in grads]
