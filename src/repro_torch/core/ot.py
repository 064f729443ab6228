"""Optimal transport for macro-level regional load balancing (§V-B1), port
of ``repro/core/ot.py``.

- :func:`normalize_masses`, :func:`cost_matrix`, :func:`routing_probs` —
  elementwise torch on whatever device the inputs live on;
- :func:`sinkhorn` — the plain float32 Sinkhorn, which is the plain
  version of the Sinkhorn kernel (``kernels/sinkhorn/ref.py``); the macro
  layer calls the kernel's wrapper, ``kernels.sinkhorn.sinkhorn_plan``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.sinkhorn.ref import sinkhorn_ref as sinkhorn


def normalize_masses(req: torch.Tensor, cap: torch.Tensor, eps: float = 1e-9
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalize raw request counts / capacities to unit mass."""
    mu = req / torch.clamp(req.sum(-1, keepdim=True), min=eps)
    nu = cap / torch.clamp(cap.sum(-1, keepdim=True), min=eps)
    return mu, nu


def cost_matrix(power_cost: torch.Tensor, latency: torch.Tensor,
                bandwidth_cost: Optional[torch.Tensor] = None,
                w1: float = 1.0, w2: float = 0.01) -> torch.Tensor:
    """C_ij = w1 * PowerCost_j + w2 * (L_ij + BandwidthCost_ij); w1 >> w2."""
    c = w1 * torch.broadcast_to(power_cost[..., None, :], latency.shape)
    bw = bandwidth_cost if bandwidth_cost is not None else 0.0
    return c + w2 * (latency + bw)


def routing_probs(plan: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-normalize plan into routing probabilities Prob_{i->j}."""
    return plan / torch.clamp(plan.sum(-1, keepdim=True), min=eps)


__all__ = ["normalize_masses", "cost_matrix", "routing_probs", "sinkhorn"]
