"""TORTA scheduler — Algorithm 1 end to end (port of ``repro/core/torta.py``,
the batch-native path with per-task region sampling).

Phase 1 (macro): the demand forecast (EMA, or a trained predictor on the
device, optionally corrupted by Dirichlet noise from the host RNG in the
reference's place), Sinkhorn OT on the device, then A_t from a trained
policy's mean action on the device or by smoothing toward the plan, then
a sampled region per task from the host RNG (the reference's exact
draws).  Phase 2 (micro): Eq-6 activation targets, then ONE multi-region
greedy per slot on the device (``micro_backend="fused"``, the port's
default), or one greedy per region (``"jax"``, optionally with the fused
score kernel) or the host walk over a kernel-made score matrix
(``"pallas"``, what ``use_compat_kernel=True`` selects).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.api import BatchDecision
from repro_torch.core.macro import MacroAllocator
from repro_torch.core.micro import MicroAllocator
from repro_torch.core.policy import PolicyNet
from repro_torch.core.predictor import Predictor
from repro_torch.obs import runtime as obs_rt


@dataclasses.dataclass
class TortaScheduler:
    n_regions: int
    seed: int = 0
    eta: float = 0.35
    sigma: float = 2.0
    headroom: float = 2.5
    # trained PPO policy and demand predictor, on ``device``
    policy_params: Optional[PolicyNet] = None
    predictor: Optional[Predictor] = None
    # Fig-12 sweep: corrupt the forecast to a target accuracy
    prediction_noise: float = 0.0
    # Phase-2 hw+load matrix from the compat_score kernel (host walk)
    use_compat_kernel: bool = False
    # Phase-2 micro backend: "fused" (one multi-region greedy per slot),
    # "jax" (the greedy one region at a time), "pallas" (host walk over
    # the compat_score kernel's matrix) or "numpy" (the same walk in
    # float64).  None = "pallas" with use_compat_kernel, else "fused"
    # (the reference's None means "numpy").
    micro_backend: Optional[str] = None
    # with micro_backend="jax": the static score from the fused_score
    # kernel (float32) instead of the float64 in-kernel row
    micro_fused_kernel: bool = False
    device: object = "cuda"
    name: str = "TORTA"

    def __post_init__(self):
        backend = self.micro_backend or (
            "pallas" if self.use_compat_kernel else "fused")
        self.macro = MacroAllocator(self.n_regions, eta=self.eta,
                                    policy_params=self.policy_params,
                                    predictor=self.predictor,
                                    device=self.device)
        self.micro = MicroAllocator(sigma=self.sigma, headroom=self.headroom,
                                    backend=backend,
                                    fused=self.micro_fused_kernel,
                                    device=self.device)
        self.device = self.macro.device
        self.reset()

    def reset(self) -> None:
        self.macro.reset()
        self.micro.reset()
        self.rng = np.random.default_rng(self.seed)
        self.prediction_log = []

    # ------------------------------------------------------------------

    def _macro_step(self, obs, demand: np.ndarray) -> np.ndarray:
        """Phase-1 macro computation: predict next-slot demand, corrupt it
        if asked, log it, and solve for A_t."""
        with obs_rt.span("macro.phase1"):
            r = self.n_regions
            q_norm = obs.queue_tasks / max(float(obs.queue_tasks.max()),
                                           1.0)
            predicted = self.macro.predict_next(demand, obs.utilization,
                                                q_norm)
            if self.prediction_noise > 0:
                noise = self.rng.dirichlet(np.ones(r))
                predicted = (1 - self.prediction_noise) * predicted \
                    + self.prediction_noise * noise
            self.prediction_log.append(np.asarray(predicted))
            # supply = capacity net of existing backlog (temporal load
            # awareness)
            cap = np.maximum(obs.capacities - obs.queue_tasks,
                             0.05 * np.maximum(obs.capacities, 1e-6))
            a = self.macro.allocate(
                demand=demand, predicted=predicted, capacity=cap,
                power_cost=obs.power_prices, latency=obs.latency,
                queue=obs.queue_s, utilization=obs.utilization,
                q_max=10.0 * float(cap.sum()) * obs.slot_seconds)
            self._predicted = predicted
        return a

    def _row_probs(self, a: np.ndarray, origin: int,
                   mask: np.ndarray) -> np.ndarray:
        pm = a[origin] * mask
        if pm.sum() <= 0:
            pm = mask.astype(float)
        if pm.sum() <= 0:
            pm = np.ones(self.n_regions)
        return pm / pm.sum()

    def schedule_batch(self, obs, batch) -> BatchDecision:
        """Batch-native Algorithm 1 over ``TaskBatch`` arrays."""
        r = self.n_regions
        n = len(batch)
        demand = batch.origin_counts(r).astype(np.float64)
        a = self._macro_step(obs, demand)

        region_of = np.full(n, -1, np.int32)
        mask = obs.capacities > 0
        for origin in np.unique(batch.origin):
            idx = np.flatnonzero(batch.origin == origin)
            pm = self._row_probs(a, int(origin), mask)
            region_of[idx] = self.rng.choice(r, size=idx.size, p=pm)

        pred_inbound = self._pred_inbound(obs, a, demand, self._predicted)
        activation = self.micro.activation_targets(obs, pred_inbound)
        if self.micro.backend == "fused":
            server_of = self.micro.assign_batch_all(obs, batch, region_of)
        else:
            server_of = np.full(n, -1, np.int32)
            for j in range(r):
                idx = np.flatnonzero(region_of == j)
                if idx.size:
                    server_of[idx] = self.micro.assign_batch(obs, j, batch,
                                                             idx)
        return BatchDecision(region=np.where(server_of >= 0, region_of, -1),
                             server=server_of, activation=activation)

    def _pred_inbound(self, obs, a, demand, predicted) -> np.ndarray:
        """Expected next-slot inbound tasks per region under A_t, trend-
        extrapolated: cold start spans ~2 slots but the forecast is 1 slot
        ahead, so ramps must be pre-warmed in time."""
        total = max(demand.sum(), 1.0)
        pred_inbound = a.T @ (predicted * total)
        hist = obs.arrivals_history
        if hist.shape[0] >= 2:
            prev_tot = max(float(hist[-2].sum()), 1.0)
            trend = float(np.clip(total / prev_tot, 1.0, 1.6))
        else:
            trend = 1.0
        pred_inbound = pred_inbound * trend
        obs_rt.record_forecast(pred_inbound)
        return pred_inbound
