"""Adam and SGD in the reference's functional form (port of
``repro/optim/adam.py``).

The parameters are a sequence of tensors (``list(module.parameters())``);
``update`` returns one update a parameter and the new state, and
``apply_updates`` adds them in place.  ``Adam.update_in_place`` gives the
same bits with less memory, for the LM train step.  The arithmetic keeps the
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
# elements the in-place update takes at a time: a stacked parameter (a
# group's layers in one tensor, 7.25 GB for falcon-mamba-7b's in_proj at 27
# layers) is updated a piece at a time, so the temporaries are a piece's;
# the operations are elementwise, so the bits are the same
PIECE = 1 << 26


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
        m = [torch.empty_like(mm) for mm in state.m]
        v = [torch.empty_like(vv) for vv in state.v]
        scalars = self._scalars(step)
        updates = [self._step(scalars, *tensors)
                   for tensors in zip(grads, state.m, state.v, params, m, v)]
        return updates, AdamState(step, m, v)

    @torch.no_grad()
    def update_in_place(self, grads: Sequence[torch.Tensor], state: AdamState,
                        params: Sequence[torch.Tensor]) -> AdamState:
        """:meth:`update` then :func:`apply_updates`, the same bits, in
        place: the gradients are clipped in place, ``state``'s moments are
        updated in place (the returned state holds the same tensors), and
        each parameter takes its step as soon as it is computed.  It keeps
        16 B a float32 parameter (the parameter, its gradient, m and v)
        where :meth:`update` keeps 32 (a clipped copy of the gradients, the
        old and the new moments, the updates), and takes each tensor
        ``PIECE`` elements at a time."""
        if self.grad_clip is not None:
            clip_by_global_norm_(grads, self.grad_clip)
        step = state.step + 1
        scalars = self._scalars(step)
        for g, mm, vv, p in zip(grads, state.m, state.v, params):
            for gp, mp, vp, pp in _pieces(g, mm, vv, p):
                pp.add_(self._step(scalars, gp, mp, vp, pp, mp, vp))
        return AdamState(step, state.m, state.v)

    def _scalars(self, step: int) -> Tuple[float, float, float]:
        """Step ``step``'s bias corrections and negated learning rate."""
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(step))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(step))
        return bc1, bc2, float(-_lr_at(self.lr, step))

    def _step(self, scalars: Tuple[float, float, float], g: torch.Tensor,
              m: torch.Tensor, v: torch.Tensor, p: torch.Tensor,
              m_out: torch.Tensor, v_out: torch.Tensor) -> torch.Tensor:
        """One tensor's Adam step: the new moments into ``m_out`` and
        ``v_out`` (``m`` and ``v`` themselves in place), and the update of
        ``p``, returned."""
        bc1, bc2, neg_lr = scalars
        g = g.float()
        torch.mul(m, self.b1, out=m_out).add_((1 - self.b1) * g)
        torch.mul(v, self.b2, out=v_out).add_((1 - self.b2) * torch.square(g))
        u = (m_out / bc1) / (torch.sqrt(v_out / bc2) + self.eps)
        if self.weight_decay:
            u = u + self.weight_decay * p.float()
        return (neg_lr * u).to(p.dtype)


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


def _pieces(*tensors: torch.Tensor):
    """Matching flat pieces of ``PIECE`` elements of same-shaped tensors,
    views into them (the whole tensors where one is not contiguous)."""
    if not all(t.is_contiguous() for t in tensors):
        yield tensors
        return
    flat = [t.view(-1) for t in tensors]
    for i in range(0, flat[0].numel(), PIECE):
        yield tuple(f[i:i + PIECE] for f in flat)


@torch.no_grad()
def apply_updates(params: Sequence[torch.Tensor],
                  updates: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """``p + u`` for every parameter, in place; returns ``params``."""
    for p, u in zip(params, updates):
        p.add_(u.to(p.dtype))
    return params


def _clip_scale(grads: Sequence[torch.Tensor], max_norm: float
                ) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(g.float())) for g in grads)
    norm = torch.sqrt(sq)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


@torch.no_grad()
def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float
                        ) -> List[torch.Tensor]:
    """The gradients scaled to a global norm of at most ``max_norm``, as
    copies (:func:`clip_by_global_norm_` scales them in place)."""
    copies = [g.clone() for g in grads]
    clip_by_global_norm_(copies, max_norm)
    return copies


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float
                         ) -> None:
    """:func:`clip_by_global_norm` into the gradients themselves, a
    ``PIECE`` at a time."""
    scale = _clip_scale(grads, max_norm)
    for whole in grads:
        for (g,) in _pieces(whole):
            g.copy_(g.float() * scale)
