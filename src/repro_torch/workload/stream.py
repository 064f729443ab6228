"""Streaming demand sources (port of ``repro/workload/stream.py``).

``StreamingWorkload`` turns a (T, R) expected-arrival matrix into one
``TaskBatch`` per slot with vectorized draws from a per-``(seed, slot)``
RNG, the reference's exact draw order; ``arrivals_matrix()`` replays just
the Poisson counts without sampling task attributes.  ``as_source``
adapts a legacy object ``Workload`` to the engine's demand-source
contract (``n_slots`` / ``n_regions`` / ``traffic`` / ``slot_batch(t)`` /
``slot_tasks(t)`` / ``arrivals_matrix()``); ``to_legacy_workload`` goes
the other way.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.sim.state import MODEL_NAMES
from repro_torch.workload.batch import (EMBED_DIM, MODEL_KIND_ID, MODEL_MEM_GB,
                                        MODEL_WORK_S, TaskBatch,
                                        zipf_model_mix)
from repro_torch.workload.legacy import Workload


@dataclasses.dataclass
class StreamingWorkload:
    """Array-native demand source over an expected-arrival matrix."""

    traffic: np.ndarray                       # (T, R) expected arrivals
    seed: int = 0
    model_mix: Optional[np.ndarray] = None    # (M,) over MODEL_NAMES
    deadline_range: Tuple[int, int] = (2, 10)  # np.integers bounds (hi excl)
    work_jitter: Tuple[float, float] = (0.5, 1.5)
    embed_dim: int = EMBED_DIM
    name: str = "stream"

    def __post_init__(self):
        self.traffic = np.asarray(self.traffic, np.float64)
        if self.model_mix is None:
            self.model_mix = zipf_model_mix()
        self.model_mix = np.asarray(self.model_mix, np.float64)
        if self.model_mix.shape != (len(MODEL_NAMES),):
            raise ValueError(
                f"model_mix must have shape ({len(MODEL_NAMES)},), "
                f"got {self.model_mix.shape}")
        self.model_mix = self.model_mix / self.model_mix.sum()

    @property
    def n_slots(self) -> int:
        return int(self.traffic.shape[0])

    @property
    def n_regions(self) -> int:
        return int(self.traffic.shape[1])

    def _slot_rng(self, t: int) -> np.random.Generator:
        return np.random.default_rng([int(self.seed) & 0x7FFFFFFF, int(t)])

    def slot_counts(self, t: int) -> np.ndarray:
        """(R,) realized Poisson arrivals of slot ``t`` (same draw the
        full ``slot_batch`` makes first)."""
        return self._slot_rng(t).poisson(self.traffic[t])

    def slot_batch(self, t: int) -> TaskBatch:
        """One slot's tasks as a ``TaskBatch`` — all draws vectorized."""
        rng = self._slot_rng(t)
        counts = rng.poisson(self.traffic[t])
        n = int(counts.sum())
        if n == 0:
            return TaskBatch.empty(self.embed_dim)
        origin = np.repeat(np.arange(self.n_regions, dtype=np.int32),
                           counts)
        midx = rng.choice(len(MODEL_NAMES), size=n,
                          p=self.model_mix).astype(np.int16)
        work = MODEL_WORK_S[midx] * rng.uniform(*self.work_jitter, size=n)
        lo, hi = self.deadline_range
        deadline = t + rng.integers(lo, hi, size=n)
        embeds = rng.standard_normal((n, self.embed_dim)).astype(np.float32)
        return TaskBatch(
            ids=(np.int64(t) << np.int64(32)) + np.arange(n, dtype=np.int64),
            origin=origin, model_idx=midx, kind_id=MODEL_KIND_ID[midx],
            work_s=work, mem_gb=MODEL_MEM_GB[midx].copy(),
            deadline_slot=deadline.astype(np.int64),
            arrival_slot=np.full(n, t, np.int64), embeds=embeds)

    def slot_tasks(self, t: int) -> list:
        """Legacy ``Task`` objects for object-path schedulers."""
        return self.slot_batch(t).to_tasks()

    def arrivals_matrix(self) -> np.ndarray:
        """(T, R) realized arrival counts (exactly what streaming the
        batches would produce, without sampling task attributes)."""
        return np.stack([self.slot_counts(t)
                         for t in range(self.n_slots)]).astype(np.float64)

    def materialize(self) -> Workload:
        """Legacy object ``Workload`` with identical per-slot content."""
        return Workload(traffic=self.traffic,
                        tasks=[self.slot_batch(t).to_tasks()
                               for t in range(self.n_slots)])


class LegacySource:
    """Demand-source view over a legacy object ``Workload``."""

    def __init__(self, workload: Workload):
        self.workload = workload
        self.name = "legacy"

    @property
    def traffic(self) -> np.ndarray:
        return self.workload.traffic

    @property
    def n_slots(self) -> int:
        return self.workload.n_slots

    @property
    def n_regions(self) -> int:
        return self.workload.traffic.shape[1]

    def slot_tasks(self, t: int) -> list:
        return list(self.workload.tasks[t])

    def slot_batch(self, t: int) -> TaskBatch:
        return TaskBatch.from_tasks(self.workload.tasks[t])

    def arrivals_matrix(self) -> np.ndarray:
        return self.workload.arrivals_matrix()


def as_source(workload):
    """Normalize either representation to the demand-source contract."""
    if isinstance(workload, Workload):
        return LegacySource(workload)
    return workload


def to_legacy_workload(workload) -> Workload:
    """The opposite adapter: a streaming source (or a legacy ``Workload``,
    returned as is) -> legacy object ``Workload``."""
    if isinstance(workload, Workload):
        return workload
    return workload.materialize()
