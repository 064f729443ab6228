"""Object-per-task workload (port of ``repro/workload/legacy.py``).

Seeded RNG draw order is the reference's, so ``make_workload`` with a
given seed yields the identical tasks.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.sim.cluster import MODEL_CATALOG, task_profile


@dataclasses.dataclass
class Task:
    id: int
    origin: int                  # region index
    model: str
    kind: str                    # compute | memory | lightweight
    work_s: float                # gpu-seconds on V100-class reference
    mem_gb: float
    deadline_slot: int
    arrival_slot: int
    embed: Optional[np.ndarray] = None   # input embedding (locality, Eq 10)


def generate_traffic(n_slots: int, n_regions: int, seed: int = 0, *,
                     base_rate: float = 6.0, diurnal_amp: float = 0.6,
                     noise: float = 0.15, surges: int = 2,
                     surge_scale: float = 2.5) -> np.ndarray:
    """(T, R) expected arrivals per slot.  One simulated 'day' spans the
    whole horizon; regions get phase offsets like time zones."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_slots)[:, None] / max(n_slots, 1)
    phase = rng.uniform(0, 2 * np.pi, n_regions)[None, :]
    weight = rng.dirichlet(np.ones(n_regions) * 2.0) * n_regions
    wave = 1.0 + diurnal_amp * np.sin(2 * np.pi * t * 2 + phase)
    traffic = base_rate * weight[None, :] * wave
    # multiplicative clamp: noise modulates but can never negate demand
    traffic *= np.maximum(
        1.0 + noise * rng.standard_normal((n_slots, n_regions)), 0.05)
    for _ in range(surges):
        s0 = int(rng.integers(n_slots // 8, max(n_slots - n_slots // 8, n_slots // 8 + 1)))
        dur = int(rng.integers(max(n_slots // 48, 2), max(n_slots // 16, 3)))
        reg = int(rng.integers(n_regions))
        traffic[s0:s0 + dur, reg] *= surge_scale
    return np.maximum(traffic, 0.1)


@dataclasses.dataclass
class Workload:
    traffic: np.ndarray          # (T, R) expected arrivals
    tasks: List[List[Task]]      # per slot

    @property
    def n_slots(self) -> int:
        return self.traffic.shape[0]

    @property
    def n_regions(self) -> int:
        return self.traffic.shape[1]

    def arrivals_matrix(self) -> np.ndarray:
        """(T, R) realized arrival counts — one bincount per slot."""
        t, r = self.traffic.shape
        out = np.zeros((t, r))
        for s, ts in enumerate(self.tasks):
            if ts:
                out[s] = np.bincount(
                    np.fromiter((task.origin for task in ts), np.int64,
                                count=len(ts)), minlength=r)[:r]
        return out


def make_workload(n_slots: int, n_regions: int, seed: int = 0,
                  **traffic_kw) -> Workload:
    rng = np.random.default_rng(seed + 1)
    traffic = generate_traffic(n_slots, n_regions, seed, **traffic_kw)
    models = list(MODEL_CATALOG)
    # zipf-ish popularity over served models
    pop = 1.0 / np.arange(1, len(models) + 1) ** 1.4
    pop /= pop.sum()
    tasks: List[List[Task]] = []
    tid = 0
    for t in range(n_slots):
        slot_tasks = []
        counts = rng.poisson(traffic[t])
        for r, c in enumerate(counts):
            for _ in range(int(c)):
                model = models[int(rng.choice(len(models), p=pop))]
                work, mem, kind = task_profile(model)
                work *= float(rng.uniform(0.5, 1.5))   # paper: uniform dist
                slot_tasks.append(Task(
                    id=tid, origin=r, model=model, kind=kind,
                    work_s=work, mem_gb=mem,
                    deadline_slot=t + int(rng.integers(2, 10)),
                    arrival_slot=t,
                    embed=rng.standard_normal(8).astype(np.float32)))
                tid += 1
        tasks.append(slot_tasks)
    return Workload(traffic=traffic, tasks=tasks)
