"""TORTA scheduler — Algorithm 1 end to end (port of ``repro/core/torta.py``).

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

``schedule_batch`` is the batch-native path (``distribution="sample"``).
The legacy object path ``schedule(obs, tasks)`` serves the ``"sticky"``
distribution (work-quota chunking with (origin, model) stickiness, which
groups ``Task`` objects; the engine routes it through the adapter, as
``supports_batch`` is False) and the frozen per-object oracle
(``sim/reference.make_reference_torta``); for ``"sample"`` it lands on
``schedule_batch``'s trajectory.  Both draw from the host RNG in the
reference's order; phase 2 runs region by region through
``MicroAllocator.assign_region``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.api import BatchDecision, SlotDecision
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
    # Phase-1 task distribution: "sample" = per-task sampling from
    # A_t[origin,:] (Algorithm 1 line 7); "sticky" = work-quota chunking
    # with (origin, model) stickiness (the object path only)
    distribution: str = "sample"
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
        # per-run state: repeated runs leak neither sticky routing nor
        # stale forecasts
        self.prediction_log = []
        self._sticky: Dict[Tuple[int, str], int] = {}

    # ------------------------------------------------------------------

    @property
    def supports_batch(self) -> bool:
        """Batch-native scheduling serves the per-task sampling
        distribution; the sticky one groups ``Task`` objects."""
        return self.distribution == "sample"

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

    def schedule(self, obs, tasks: List) -> SlotDecision:
        """Legacy object path over ``Task`` objects: the ``"sticky"``
        distribution and the frozen oracle's scheduler.  For ``"sample"``
        the same draws as ``schedule_batch`` (one batched draw per origin,
        origins in first-seen order)."""
        r = self.n_regions
        origins = np.fromiter((t.origin for t in tasks), np.int64,
                              count=len(tasks))
        demand = np.bincount(origins, minlength=r).astype(np.float64)
        a = self._macro_step(obs, demand)
        predicted = self._predicted

        # Phase 1: distribute tasks per A_t[origin, :]
        by_region: Dict[int, List] = {j: [] for j in range(r)}
        mask = obs.capacities > 0
        by_origin: Dict[int, List] = {}
        for task in tasks:
            by_origin.setdefault(task.origin, []).append(task)
        if self.distribution == "sample":
            for origin, group in by_origin.items():
                pm = self._row_probs(a, origin, mask)
                js = self.rng.choice(r, size=len(group), p=pm)
                for task, j in zip(group, js):
                    by_region[int(j)].append(task)
            return self._phase2(obs, a, demand, predicted, by_region)
        for origin, group in by_origin.items():
            pm = self._row_probs(a, origin, mask)
            # same-model tasks stay together (warm locality), apportioned
            # by WORK to the region with the largest remaining quota
            by_model: Dict[str, List] = {}
            for tk in group:
                by_model.setdefault(tk.model, []).append(tk)
            total_work = sum(tk.work_s for tk in group)
            quota = pm * total_work
            q_cap = max(float(quota.max()), 1e-6)
            # under stress (queues building anywhere) chunk finely and
            # follow the quotas; in steady state keep big sticky chunks
            stress = float(np.max(obs.queue_tasks /
                                  np.maximum(obs.capacities, 1e-6))) > 0.10
            chunk_scale = 1.0 if stress else 2.0
            sticky_slack = 0.5 if stress else -0.25
            subgroups = sorted(by_model.values(),
                               key=lambda g2: -sum(tk.work_s for tk in g2))
            for g2 in subgroups:
                w2 = sum(tk.work_s for tk in g2)
                n_chunks = max(1, int(np.ceil(w2 / (chunk_scale * q_cap))))
                step = max(1, -(-len(g2) // n_chunks))
                for k0 in range(0, len(g2), step):
                    part = g2[k0:k0 + step]
                    pw = sum(tk.work_s for tk in part)
                    key = (origin, part[0].model)
                    j = self._sticky.get(key, -1)
                    if j < 0 or quota[j] < sticky_slack * pw or not mask[j]:
                        j = int(np.argmax(quota))
                    self._sticky[key] = j
                    by_region[j].extend(part)
                    quota[j] -= pw
        return self._phase2(obs, a, demand, predicted, by_region)

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

    def _phase2(self, obs, a, demand, predicted, by_region) -> SlotDecision:
        """Phase 2 of the object path: each region's Eq-6 target and its
        tasks through ``micro.assign_region``."""
        assignments: Dict[int, Optional[Tuple[int, int]]] = {}
        activation: Dict[int, int] = {}
        pred_inbound = self._pred_inbound(obs, a, demand, predicted)
        for j in range(self.n_regions):
            activation[j] = self.micro.activation_target(
                obs, j, float(pred_inbound[j]))
            assignments.update(self.micro.assign_region(obs, j, by_region[j]))
        return SlotDecision(assignments=assignments, activation=activation)
