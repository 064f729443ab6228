"""Plain PyTorch versions of the compatibility-score kernels.

Op for op after the reference's ``repro/kernels/compat_score/ref.py``
(``compat_score_ref``, ``fused_score_ref``), all in float32: the kind dot
summed left to right, the locality term added before the warm term.  The
CPU path of ``ops.compat_score`` / ``ops.fused_score`` and the yardstick
the CUDA kernels are held to on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

W_HW, W_LOAD, W_LOC = 0.4, 0.4, 0.2      # Eq 7 weights
W_WARM = 2.0                             # same-model (no-switch) bonus


def compat_score_ref(task_feats: torch.Tensor, server_feats: torch.Tensor,
                     locality: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """(N, 8) x (S, 8) [x (N, S)] -> (N, S) float32
    ``W_HW*hw + W_LOAD*load [+ W_LOC*locality]``."""
    tf = task_feats.float()
    sf = server_feats.float()
    c = torch.clamp(sf[None, :, 0] / torch.clamp(tf[:, None, 0], min=1e-9),
                    max=1.0)
    m = torch.clamp(sf[None, :, 1] / torch.clamp(tf[:, None, 1], min=1e-9),
                    max=1.0)
    match = tf[:, None, 2] * sf[None, :, 2]
    match = match + tf[:, None, 3] * sf[None, :, 3]
    match = match + tf[:, None, 4] * sf[None, :, 4]
    hw = c * m * (0.5 + 0.5 * match)
    load = torch.exp(-4.0 * (sf[None, :, 5] + sf[None, :, 6])
                     / torch.clamp(sf[None, :, 7], min=1e-9))
    out = W_HW * hw + W_LOAD * load
    if locality is not None:
        out = out + W_LOC * locality.float()
    return out


def fused_score_ref(task_feats: torch.Tensor, server_feats: torch.Tensor,
                    task_mids: torch.Tensor, server_models: torch.Tensor,
                    locality: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, 8) x (S, 8) x (N,) x (S, 1+W) [x (N, S)] -> (N, S) float32
    ``compat_score_ref + W_WARM*warm``: warm is 1.0 where the task's model
    id equals the server's current one, 0.4 where it is one of the
    server's warm ids, else 0."""
    base = compat_score_ref(task_feats, server_feats, locality)
    mid = task_mids.float()[:, None]
    sm = server_models.float()
    hit = (sm[None, :, 1:] == mid[:, :, None]).any(dim=2)
    warm = torch.where(mid == sm[None, :, 0], 1.0,
                       torch.where(hit, 0.4, 0.0))
    return base + W_WARM * warm
