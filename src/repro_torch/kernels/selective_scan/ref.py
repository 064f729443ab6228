"""Plain PyTorch version of the selective-scan kernel: the Pallas kernel's
jnp oracle (``repro/kernels/selective_scan/ref.py``, a sequential
recurrence) in torch, also returning the last state.  The CPU path of
:func:`repro_torch.kernels.selective_scan.ops.selective_scan` and the
yardstick the CUDA kernel is held to on the card."""
from __future__ import annotations

from typing import Tuple

import torch


def selective_scan_ref(dt: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
                       x: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt, x: (B, S, D); bm, cm: (B, S, N); a: (D, N); d_skip: (D,) ->
    (y (B, S, D) in x's type, last state h (B, D, N) float32), with
    ``h_s = exp(dt_s A) h_{s-1} + (dt_s x_s) bm_s``, ``y_s = h_s . cm_s +
    d_skip x_s``.  Computes in float32 (float64, and a float64 state, for
    float64 operands)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    dtf, xf = dt.to(acc), x.to(acc)
    bmf, cmf, af = bm.to(acc), cm.to(acc), a.to(acc)
    b, s, d = x.shape
    h = torch.zeros((b, d, a.shape[-1]), dtype=acc, device=x.device)
    ys = []
    for t in range(s):
        abar = torch.exp(dtf[:, t, :, None] * af)               # (B, D, N)
        bx = (dtf[:, t] * xf[:, t])[:, :, None] * bmf[:, t, None, :]
        h = abar * h + bx
        ys.append(torch.einsum("bdn,bn->bd", h, cmf[:, t]))
    y = torch.stack(ys, dim=1) + d_skip.to(acc) * xf
    return y.to(x.dtype), h
