"""The gradient of the selective scan: the ``selective_scan`` kernel as a
``torch.autograd.Function``.

The forward is the hand-written kernel on the card (the plain version on
the CPU), run with ``states`` so that it also returns the state each
chunk of ``ops.STEPS`` (16) steps starts from.  The backward is
``ops.selective_scan_bwd``, the hand-written backward kernel on the card
(the plain reverse recurrence on the CPU), which rebuilds each chunk's
states from those boundaries.  Both are looked up on ``ops`` at each call.
The reference has no backward kernel to port: its train step
differentiates ``associative_scan`` with ``jax.value_and_grad``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.selective_scan import ops


class SelectiveScan(torch.autograd.Function):
    """``ops.selective_scan`` forward, ``ops.selective_scan_bwd``
    backward; a gradient of ``None`` for the last state is taken as 0."""

    @staticmethod
    def forward(ctx, dt, bm, cm, x, a, d_skip):
        y, h_last, h_chunks = ops.selective_scan(dt, bm, cm, x, a, d_skip,
                                                 states=True)
        ctx.save_for_backward(dt, bm, cm, x, a, d_skip, h_chunks)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        dt, bm, cm, x, a, d_skip, h_chunks = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        return ops.selective_scan_bwd(dt, bm, cm, x, a, d_skip, dy, dh_last,
                                      h_chunks=h_chunks)


def selective_scan_grad(dt: torch.Tensor, bm: torch.Tensor,
                        cm: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
                        d_skip: torch.Tensor):
    """:func:`ops.selective_scan` under autograd: the same operands and
    outputs (y, last state), with the backward kernel as its gradient."""
    return SelectiveScan.apply(dt, bm, cm, x, a, d_skip)
