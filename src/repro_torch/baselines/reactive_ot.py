"""Reactive-OT baseline (port of ``repro/baselines/reactive_ot.py``): the
single-timeslot performance upper bound of Thm 1 — per-slot optimal
transport on the CURRENT state only (no prediction, no temporal
smoothing), with the same micro layer as TORTA.  This is the method-class
whose switching cost converges to K0 (Thm 2); ``theory.estimate_k0``
reads its ``switching_costs()``.

On ``device``: the OT plan through the Sinkhorn kernel's wrapper
(``MacroAllocator.ot_plan``), once a slot, and each region's server
matching through ``MicroAllocator.assign_batch`` on the ``fused`` backend,
one greedy launch a region.  Region sampling draws one batched
``rng.choice`` per origin on the host, in the reference's order."""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.api import BatchDecision, SlotDecision, schedule_via_batch
from repro_torch.core.macro import MacroAllocator
from repro_torch.core.micro import MicroAllocator
from repro_torch.sim.engine import SlotObs


@dataclasses.dataclass
class ReactiveOTScheduler:
    n_regions: int
    seed: int = 0
    name: str = "ReactiveOT"
    supports_batch: bool = True
    device: object = "cuda"

    def __post_init__(self):
        self.macro = MacroAllocator(self.n_regions, eta=1.0,  # no smoothing
                                    device=self.device)
        self.micro = MicroAllocator(device=self.device)
        self.device = self.macro.device
        self.rng = np.random.default_rng(self.seed)
        self.a_hist: List[np.ndarray] = []

    def reset(self) -> None:
        self.macro.reset()
        self.micro.reset()
        self.rng = np.random.default_rng(self.seed)
        self.a_hist = []

    def schedule_batch(self, obs: SlotObs, batch) -> BatchDecision:
        r = self.n_regions
        n = len(batch)
        demand = batch.origin_counts(r).astype(np.float64)
        cap = np.maximum(obs.capacities - obs.queue_tasks,
                         0.05 * np.maximum(obs.capacities, 1e-6))
        # pure per-slot OT: current demand only (memoryless, Definition 1)
        probs = self.macro.ot_plan(np.maximum(demand, 1e-3), cap,
                                   obs.power_prices, obs.latency)
        self.a_hist.append(probs.copy())
        region_of = np.full(n, -1, np.int32)
        for origin in np.unique(batch.origin):
            idx = np.flatnonzero(batch.origin == origin)
            p = probs[int(origin)] * (obs.capacities > 0)
            if p.sum() <= 0:
                p = np.ones(r)
            p = p / p.sum()
            region_of[idx] = self.rng.choice(r, size=idx.size, p=p)
        activation = np.empty(r, np.int64)       # api array form
        server_of = np.full(n, -1, np.int32)
        inbound = probs.T @ demand
        for j in range(r):
            # reactive activation: current queue only, no forecast
            activation[j] = self.micro.activation_target(obs, j,
                                                         float(inbound[j]))
            idx = np.flatnonzero(region_of == j)
            if idx.size:
                server_of[idx] = self.micro.assign_batch(obs, j, batch, idx)
        return BatchDecision(region=np.where(server_of >= 0, region_of, -1),
                             server=server_of, activation=activation)

    def schedule(self, obs: SlotObs, tasks: List) -> SlotDecision:
        """Object-path shim over the batch contract."""
        return schedule_via_batch(self, obs, tasks)

    def switching_costs(self) -> np.ndarray:
        """||A_t - A_{t-1}||_F^2 series — feeds theory.estimate_k0."""
        if len(self.a_hist) < 2:
            return np.zeros(1)
        return np.array([float(np.sum((a2 - a1) ** 2))
                         for a1, a2 in zip(self.a_hist, self.a_hist[1:])])
