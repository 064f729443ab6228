"""Plain PyTorch versions of the selective-scan kernels.

:func:`selective_scan_ref` is the Pallas kernel's jnp oracle
(``repro/kernels/selective_scan/ref.py``, a sequential recurrence) in
torch, also returning the last state (and, given ``states``, the state
each chunk of ``STEPS`` steps starts from).  :func:`selective_scan_bwd_ref` is its
gradient as an explicit reverse recurrence: the reference has no backward
kernel (its train step differentiates ``associative_scan`` with XLA), so
this is written against the math.  Both are the CPU path of
:mod:`repro_torch.kernels.selective_scan.ops` and the yardsticks the CUDA
kernels are held to on the card."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

# steps a chunk of saved states: the forward saves the state each chunk
# starts from, the backward rebuilds a chunk's states in registers
STEPS = 16


def selective_scan_ref(dt: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
                       x: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
                       *, states: bool = False):
    """dt, x: (B, S, D); bm, cm: (B, S, N); a: (D, N); d_skip: (D,) ->
    (y (B, S, D) in x's type, last state h (B, D, N) float32), with
    ``h_s = exp(dt_s A) h_{s-1} + (dt_s x_s) bm_s``, ``y_s = h_s . cm_s +
    d_skip x_s``.  Given ``states``, also the state each run of ``STEPS``
    steps starts from, ``h_{k STEPS - 1}`` (zeros for k = 0), as
    (B, ceil(S / STEPS), D, N).  Computes in float32 (float64, and a
    float64 state, for float64 operands)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    dtf, xf = dt.to(acc), x.to(acc)
    bmf, cmf, af = bm.to(acc), cm.to(acc), a.to(acc)
    b, s, d = x.shape
    h = torch.zeros((b, d, a.shape[-1]), dtype=acc, device=x.device)
    ys, starts = [], []
    for t in range(s):
        if states and t % STEPS == 0:
            starts.append(h)
        abar = torch.exp(dtf[:, t, :, None] * af)               # (B, D, N)
        bx = (dtf[:, t] * xf[:, t])[:, :, None] * bmf[:, t, None, :]
        h = abar * h + bx
        ys.append(torch.einsum("bdn,bn->bd", h, cmf[:, t]))
    y = torch.stack(ys, dim=1) + d_skip.to(acc) * xf
    if not states:
        return y.to(x.dtype), h
    return y.to(x.dtype), h, torch.stack(starts, dim=1)


def selective_scan_bwd_ref(dt: torch.Tensor, bm: torch.Tensor,
                           cm: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
                           d_skip: torch.Tensor, dy: torch.Tensor,
                           dh_last: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`selective_scan_ref`'s (y, h_last) given
    their cotangents ``dy`` (B, S, D) and ``dh_last`` (B, D, N, or None
    for 0) -> (d dt, d bm, d cm, d x, d a, d d_skip), each in its
    operand's type.  With ``u_s = dt_s x_s``, ``a_s = exp(dt_s A)`` and
    ``g_s = dy_s cm_s + a_{s+1} g_{s+1}`` (the gradient of h_s, seeded by
    ``dh_last``): ``d cm_s = sum_d h_s dy_s``, ``d bm_s = sum_d g_s u_s``,
    ``du_s = sum_n g_s bm_s``, ``dx_s = du_s dt_s + d_skip dy_s``,
    ``d dt_s = du_s x_s + sum_n g_s h_{s-1} a_s A``, ``dA = sum_{b,s} g_s
    h_{s-1} a_s dt_s``, ``d d_skip = sum_{b,s} dy_s x_s``.  Keeps every
    state; computes in float32 (float64 for float64 operands)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    dtf, bmf, cmf, xf, af, dyf = (t.to(acc) for t in (dt, bm, cm, x, a, dy))
    b, s, d = x.shape
    h = torch.zeros((b, d, a.shape[-1]), dtype=acc, device=x.device)
    hs = [h]                                   # hs[t + 1] = h_t
    for t in range(s):
        h = torch.exp(dtf[:, t, :, None] * af) * h \
            + (dtf[:, t] * xf[:, t])[:, :, None] * bmf[:, t, None, :]
        hs.append(h)
    carry = torch.zeros_like(h) if dh_last is None else dh_last.to(acc)
    d_dt, d_x = torch.empty_like(dtf), torch.empty_like(xf)
    d_bm, d_cm = torch.empty_like(bmf), torch.empty_like(cmf)
    d_a = torch.zeros_like(af)
    for t in reversed(range(s)):
        abar = torch.exp(dtf[:, t, :, None] * af)
        g = dyf[:, t, :, None] * cmf[:, t, None, :] + carry     # (B, D, N)
        d_cm[:, t] = torch.einsum("bdn,bd->bn", hs[t + 1], dyf[:, t])
        d_bm[:, t] = torch.einsum("bdn,bd->bn", g, dtf[:, t] * xf[:, t])
        du = torch.einsum("bdn,bn->bd", g, bmf[:, t])
        w = g * hs[t] * abar
        d_x[:, t] = du * dtf[:, t] + d_skip.to(acc) * dyf[:, t]
        d_dt[:, t] = du * xf[:, t] + (w * af).sum(-1)
        d_a += (w * dtf[:, t, :, None]).sum(0)
        carry = abar * g
    d_d = (dyf * xf).sum((0, 1))
    return (d_dt.to(dt.dtype), d_bm.to(bm.dtype), d_cm.to(cm.dtype),
            d_x.to(x.dtype), d_a.to(a.dtype), d_d.to(d_skip.dtype))
