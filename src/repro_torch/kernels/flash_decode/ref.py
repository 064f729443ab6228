"""Plain PyTorch version of the decode attention kernel: the Pallas
kernel's jnp oracle (``repro/kernels/flash_decode/ref.py``) in torch.
The CPU path of :func:`repro_torch.kernels.flash_decode.ops.flash_decode`
and the yardstick the CUDA kernel is held to on the card."""
from __future__ import annotations

import torch

NEG_INF = -1e30        # the Pallas kernel's mask value


def flash_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid: torch.Tensor
                     ) -> torch.Tensor:
    """q: (B, KH, G, hd); caches: (B, C, KH, hd); valid: (B, C) ->
    (B, KH, G, hd).  A row with no valid position averages the cache.
    Computes in float32 (float64 for float64 operands)."""
    hd = q.shape[-1]
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bkgh,bckh->bkgc", q.to(acc),
                     k_cache.to(acc)) * hd ** -0.5
    s = torch.where(valid[:, None, None, :] > 0, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgc,bckh->bkgh", p, v_cache.to(acc)).to(q.dtype)
