"""Macro-level allocation (§V-B), port of ``repro/core/macro.py``: EMA
demand forecast + Sinkhorn OT + temporal smoothing, producing the
inter-region allocation matrix A_t.

The OT plan is computed on ``device`` in float32 through the Sinkhorn
kernel's wrapper (the reference's ``use_sinkhorn_kernel=True`` route);
the forecast and the float64 smoothing stay host numpy, as in the
reference.  A trained PPO policy is not ported: passing one raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.ot import cost_matrix, normalize_masses, routing_probs
from repro_torch.core.predictor import K_HIST, EmaPredictor
from repro_torch.kernels.sinkhorn import sinkhorn_plan


@dataclasses.dataclass
class MacroAllocator:
    n_regions: int
    # smoothing step toward the OT plan (the fixed point the
    # smoothness-regularized policy converges to)
    eta: float = 0.35
    reg: float = 0.05
    policy_params: Optional[object] = None
    device: object = "cuda"

    def __post_init__(self):
        if self.policy_params is not None:
            raise NotImplementedError(
                "the learned macro policy is not ported yet; "
                "MacroAllocator runs the smoothed OT plan only")
        self.device = resolve_device(self.device)
        self.reset()

    def reset(self) -> None:
        r = self.n_regions
        self.a_prev = np.full((r, r), 1.0 / r)
        self.ema = EmaPredictor(r)
        self.hist = np.full((K_HIST, r), 1.0 / r)
        self.prev_nu = np.full((r,), 1.0 / r)

    # ------------------------------------------------------------------

    def predict_next(self, arrivals: np.ndarray) -> np.ndarray:
        """Update history with realized arrivals; forecast the next
        distribution."""
        self.ema.update(arrivals)
        dist = arrivals / max(arrivals.sum(), 1e-9)
        self.hist = np.concatenate([self.hist[1:], dist[None]], axis=0)
        return self.ema.predict()

    def ot_plan(self, demand: np.ndarray, capacity: np.ndarray,
                power_cost: np.ndarray, latency: np.ndarray) -> np.ndarray:
        """Row-normalized float32 OT plan, as host numpy."""
        def dev32(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)
        mu, nu = normalize_masses(dev32(demand), dev32(capacity))
        c = cost_matrix(dev32(power_cost / max(power_cost.max(), 1e-9)),
                        dev32(latency / max(latency.max(), 1e-9)))
        plan = sinkhorn_plan(mu[None], nu[None], c[None], reg=self.reg)[0]
        return routing_probs(plan).cpu().numpy()

    def allocate(self, *, demand: np.ndarray, predicted: np.ndarray,
                 capacity: np.ndarray, power_cost: np.ndarray,
                 latency: np.ndarray) -> np.ndarray:
        """A_t given current demand + forecast. Row-stochastic (R, R)."""
        # blend realized demand with the forecast (temporal awareness)
        blended = 0.5 * demand + 0.5 * predicted * max(demand.sum(), 1.0)
        probs = self.ot_plan(blended, capacity, power_cost, latency)
        nu = capacity / max(capacity.sum(), 1e-9)
        shock = float(np.abs(nu - self.prev_nu).sum()) > 0.25
        self.prev_nu = nu
        # temporally-smoothed OT: A_t = (1-eta) A_{t-1} + eta P*, except
        # under a supply shock (regional failure / recovery), which snaps
        # to P*
        eta = 1.0 if shock else self.eta
        a = (1 - eta) * self.a_prev + eta * probs
        a = a / np.maximum(a.sum(1, keepdims=True), 1e-9)
        self.a_prev = a
        return a
