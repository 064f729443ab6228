"""Optimal transport for macro-level regional load balancing (§V-B1), port
of ``repro/core/ot.py``.

- :func:`normalize_masses`, :func:`cost_matrix`, :func:`routing_probs` —
  elementwise torch on whatever device the inputs live on;
- :func:`sinkhorn` — the plain float32 Sinkhorn, which is the plain
  version of the Sinkhorn kernel (``kernels/sinkhorn/ref.py``); the macro
  layer, the training env and the K0 estimate call the kernel's wrapper,
  ``kernels.sinkhorn.sinkhorn_plan``;
- :func:`exact_ot` — the LP plan by scipy's HiGHS, host numpy, the
  oracle of the tests and of Thm-1 baselines.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.sinkhorn import sinkhorn_plan
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


def ot_cost(plan: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    return torch.sum(plan * cost, dim=(-2, -1))


def routing_probs(plan: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-normalize plan into routing probabilities Prob_{i->j}."""
    return plan / torch.clamp(plan.sum(-1, keepdim=True), min=eps)


def slot_routing_probs(traffic: np.ndarray, capacity: np.ndarray,
                       power_cost: np.ndarray, latency: np.ndarray, *,
                       reg: float, device: torch.device) -> torch.Tensor:
    """(T, R, R) routing probabilities of the OT plan of every slot of a
    (T, R) traffic trace against a fixed capacity: one (T, R) launch of
    the Sinkhorn kernel, float32 on ``device`` (the reference's env and
    K0 estimate, which solve the whole trace as one batch)."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    t_total, r = traffic.shape
    cost = cost_matrix(f32(power_cost), f32(latency))
    mu, nu = normalize_masses(f32(traffic), f32(capacity).expand(t_total, r))
    return routing_probs(sinkhorn_plan(mu, nu, cost.expand(t_total, r, r),
                                       reg=reg))


def exact_ot(mu: np.ndarray, nu: np.ndarray, cost: np.ndarray) -> np.ndarray:
    """Exact LP transport plan of one problem (scipy HiGHS, host numpy)."""
    from scipy.optimize import linprog
    r = mu.shape[0]
    a_eq = np.zeros((2 * r, r, r))
    for i in range(r):
        a_eq[i, i, :] = 1                           # row marginals
        a_eq[r + i, :, i] = 1                       # column marginals
    res = linprog(cost.reshape(-1), A_eq=a_eq.reshape(2 * r, -1),
                  b_eq=np.concatenate([mu, nu]), bounds=(0, None),
                  method="highs")
    if not res.success:
        raise RuntimeError(f"exact OT failed: {res.message}")
    return res.x.reshape(r, r)


__all__ = ["normalize_masses", "cost_matrix", "ot_cost", "routing_probs",
           "sinkhorn", "slot_routing_probs", "exact_ot"]
