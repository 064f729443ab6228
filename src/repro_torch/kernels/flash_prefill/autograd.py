"""The gradient of causal prefill attention: the ``flash_prefill`` kernel
as a ``torch.autograd.Function``.

The forward is the hand-written kernel on the card (the plain version on
the CPU), looked up on ``ops`` at each call.  The backward,
:func:`flash_prefill_bwd`, is explicit torch operations, recomputed from
the saved ``q, k, v, o``: the reference has no backward kernel to port
(its train step differentiates its XLA attention with
``jax.value_and_grad``, and no Pallas kernel of it has a ``custom_vjp``).
A hand-written backward kernel (dK/dV and dQ) is a later speed-up.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_prefill import ops
from repro_torch.kernels.flash_prefill.ref import NEG_INF

# query rows a chunk of the backward: the reference's XLA attention's
# ``q_chunk``, so the transient scores stay (B, KH, G, chunk, keys)
BWD_CHUNK = 1024


def flash_prefill_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, *, window=None,
                      chunk: int = BWD_CHUNK):
    """q, o, do: (B, KH, G, S, hd); k, v: (B, KH, S, hd) -> (dq, dk, dv)
    in the operands' types, of causal attention with an optional window
    (``o`` the forward's output, ``do`` its cotangent).  Per chunk of
    query rows, in float32 (float64 for float64 operands):
    ``S = q k^T hd^-0.5`` under the mask over the keys the chunk sees,
    ``P = softmax(S)``, ``D = rowsum(dO * o)``, ``dV += P^T dO``,
    ``dP = dO V^T``, ``dS = P (dP - D) hd^-0.5``, ``dQ = dS K``,
    ``dK += dS^T Q``, each KV head summed over its G query heads."""
    s_len, hd = q.shape[3], q.shape[-1]
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = hd ** -0.5
    qf, kf, vf, of, dof = (t.to(acc) for t in (q, k, v, o, do))
    dq = torch.empty_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    pos = torch.arange(s_len, device=q.device)
    for s0 in range(0, s_len, chunk):
        s1 = min(s0 + chunk, s_len)
        # the keys a row of the chunk may see: causal up to s1 - 1, and
        # from its first row's window on
        t0 = 0 if window is None else max(0, s0 - window + 1)
        qc, doc = qf[..., s0:s1, :], dof[..., s0:s1, :]
        kc, vc = kf[:, :, t0:s1], vf[:, :, t0:s1]
        qpos, kpos = pos[s0:s1, None], pos[None, t0:s1]
        ok = kpos <= qpos
        if window is not None:
            ok &= kpos > qpos - window
        scores = torch.einsum("bkgqh,bkth->bkgqt", qc, kc) * scale
        p = torch.softmax(torch.where(ok, scores, NEG_INF), dim=-1)
        d = (doc * of[..., s0:s1, :]).sum(dim=-1, keepdim=True)
        dv[:, :, t0:s1] += torch.einsum("bkgqt,bkgqh->bkth", p, doc)
        ds = p * (torch.einsum("bkgqh,bkth->bkgqt", doc, vc) - d) * scale
        dq[..., s0:s1, :] = torch.einsum("bkgqt,bkth->bkgqh", ds, kc)
        dk[:, :, t0:s1] += torch.einsum("bkgqt,bkgqh->bkth", ds, qc)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashPrefill(torch.autograd.Function):
    """``ops.flash_prefill`` forward, :func:`flash_prefill_bwd` backward."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        o = ops.flash_prefill(q, k, v, window=window)
        ctx.save_for_backward(q, k, v, o)
        ctx.window = window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = flash_prefill_bwd(q, k, v, o, do, window=ctx.window)
        return dq, dk, dv, None


def flash_prefill_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, window=None) -> torch.Tensor:
    """:func:`ops.flash_prefill` under autograd: the same operands and
    output, with :func:`flash_prefill_bwd` as its backward."""
    return FlashPrefill.apply(q, k, v, window)
