"""Plain PyTorch version of the prefill attention kernel: the Pallas
kernel's jnp oracle (``repro/kernels/flash_prefill/ref.py``) in torch.
The CPU path of :func:`repro_torch.kernels.flash_prefill.ops.flash_prefill`
and the yardstick the CUDA kernel is held to on the card."""
from __future__ import annotations

import torch

NEG_INF = -1e30        # the Pallas kernel's mask value


def flash_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window=None) -> torch.Tensor:
    """q: (B, KH, G, S, hd); k, v: (B, KH, S, hd) -> (B, KH, G, S, hd),
    causal, keys within ``window`` of the query when it is given.
    Computes in float32 (float64 for float64 operands)."""
    s_len, hd = q.shape[3], q.shape[-1]
    acc = torch.promote_types(q.dtype, torch.float32)
    scores = torch.einsum("bkgsh,bkth->bkgst", q.to(acc),
                          k.to(acc)) * hd ** -0.5
    pos = torch.arange(s_len, device=q.device)
    qpos, kpos = pos[:, None], pos[None, :]
    ok = kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    scores = torch.where(ok, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgst,bkth->bkgsh", p, v.to(acc)).to(q.dtype)
