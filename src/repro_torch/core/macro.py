"""Macro-level allocation (§V-B), port of ``repro/core/macro.py``: demand
forecast (the EMA, or a trained ``Predictor``) + Sinkhorn OT + either
temporal smoothing or a trained PPO policy, producing the inter-region
allocation matrix A_t.

The OT plan is computed on ``device`` in float32 through the Sinkhorn
kernel's wrapper (the reference's ``use_sinkhorn_kernel=True`` route),
every slot, with or without a policy, as in the reference.  The
predictor and the policy's mean action run on ``device`` in float32;
the histories, the observation vector and the row normalisation stay
host numpy, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import policy as pol
from repro_torch.core.ot import cost_matrix, normalize_masses, routing_probs
from repro_torch.core.predictor import K_HIST, EmaPredictor, Predictor
from repro_torch.kernels.sinkhorn import sinkhorn_plan


@dataclasses.dataclass
class MacroAllocator:
    n_regions: int
    # smoothing step toward the OT plan (the fixed point the
    # smoothness-regularized policy converges to)
    eta: float = 0.35
    reg: float = 0.05
    # trained PPO policy (``core.policy.PolicyNet``) and demand predictor
    # (``core.predictor.Predictor``), on ``device``
    policy_params: Optional[pol.PolicyNet] = None
    predictor: Optional[Predictor] = None
    device: object = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.reset()

    def reset(self) -> None:
        r = self.n_regions
        self.a_prev = np.full((r, r), 1.0 / r)
        self.ema = EmaPredictor(r)
        self.hist = np.full((K_HIST, r), 1.0 / r)
        # (K, 3R) = [U, Q, H] channels per slot, the predictor's input
        self.feat_hist = np.zeros((K_HIST, 3 * r), np.float32)
        self.feat_hist[:, 2 * r:] = 1.0 / r
        self.prev_nu = np.full((r,), 1.0 / r)

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # ------------------------------------------------------------------

    def predict_next(self, arrivals: np.ndarray,
                     util: Optional[np.ndarray] = None,
                     queue_norm: Optional[np.ndarray] = None) -> np.ndarray:
        """Update history with realized state; forecast the next
        distribution."""
        r = self.n_regions
        self.ema.update(arrivals)
        dist = arrivals / max(arrivals.sum(), 1e-9)
        self.hist = np.concatenate([self.hist[1:], dist[None]], axis=0)
        feat = np.concatenate([
            util if util is not None else np.zeros(r),
            queue_norm if queue_norm is not None else np.zeros(r),
            dist]).astype(np.float32)
        self.feat_hist = np.concatenate([self.feat_hist[1:], feat[None]],
                                        axis=0)
        if self.predictor is not None:
            with torch.no_grad():
                return self.predictor(self._on_device(self.feat_hist)) \
                    .cpu().numpy()
        return self.ema.predict()

    def ot_plan(self, demand: np.ndarray, capacity: np.ndarray,
                power_cost: np.ndarray, latency: np.ndarray) -> np.ndarray:
        """Row-normalized float32 OT plan, as host numpy."""
        mu, nu = normalize_masses(self._on_device(demand),
                                  self._on_device(capacity))
        c = cost_matrix(
            self._on_device(power_cost / max(power_cost.max(), 1e-9)),
            self._on_device(latency / max(latency.max(), 1e-9)))
        plan = sinkhorn_plan(mu[None], nu[None], c[None], reg=self.reg)[0]
        return routing_probs(plan).cpu().numpy()

    def allocate(self, *, demand: np.ndarray, predicted: np.ndarray,
                 capacity: np.ndarray, power_cost: np.ndarray,
                 latency: np.ndarray, queue: np.ndarray,
                 utilization: np.ndarray, q_max: float) -> np.ndarray:
        """A_t given current demand + forecast. Row-stochastic (R, R)."""
        # blend realized demand with the forecast (temporal awareness)
        blended = 0.5 * demand + 0.5 * predicted * max(demand.sum(), 1.0)
        probs = self.ot_plan(blended, capacity, power_cost, latency)
        # track realized supply on every call, so that a policy turned
        # off later sees no stale "supply shock"
        nu = capacity / max(capacity.sum(), 1e-9)
        shock = float(np.abs(nu - self.prev_nu).sum()) > 0.25
        self.prev_nu = nu
        if self.policy_params is not None:
            obs = np.concatenate([
                utilization,
                queue / max(q_max, 1e-9),
                (latency / max(latency.max(), 1e-9)).reshape(-1),
                self.hist.reshape(-1),
                predicted,
                self.a_prev.reshape(-1),
            ]).astype(np.float32)
            with torch.no_grad():
                a = pol.mean_action(self.policy_params, self._on_device(obs),
                                    self.n_regions).cpu().numpy()
        else:
            # temporally-smoothed OT: A_t = (1-eta) A_{t-1} + eta P*,
            # except under a supply shock (regional failure / recovery),
            # which snaps to P*
            eta = 1.0 if shock else self.eta
            a = (1 - eta) * self.a_prev + eta * probs
        a = a / np.maximum(a.sum(1, keepdims=True), 1e-9)
        self.a_prev = a
        return a
