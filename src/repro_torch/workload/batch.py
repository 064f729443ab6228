"""Struct-of-arrays task batches (port of ``repro/workload/batch.py``).

Model identity is the integer index into ``sim.state.MODEL_NAMES``;
per-model work/memory/kind lookups are precomputed catalog arrays.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from repro_torch.sim.cluster import task_profile
from repro_torch.sim.state import KIND_IDS, KINDS, MODEL_NAMES, model_id

EMBED_DIM = 8

# catalog arrays, indexed by model id (== position in MODEL_NAMES)
MODEL_WORK_S = np.array([task_profile(m)[0] for m in MODEL_NAMES])
MODEL_MEM_GB = np.array([task_profile(m)[1] for m in MODEL_NAMES],
                        np.float64)
MODEL_KIND_ID = np.array([KIND_IDS[task_profile(m)[2]] for m in MODEL_NAMES],
                         np.int8)


def group_rows(keys: np.ndarray):
    """Yield ``(gi, key, rows)`` per distinct key over a per-row key array,
    in order of each key's FIRST OCCURRENCE; ``rows`` preserves original
    row order and ``gi`` indexes the sorted-unique key.  One argsort
    total."""
    keys = np.asarray(keys)
    uniq, first, inverse = np.unique(keys, return_index=True,
                                     return_inverse=True)
    starts = np.concatenate(
        ([0], np.cumsum(np.bincount(inverse, minlength=uniq.size))))
    grouped = np.argsort(inverse, kind="stable")
    for gi in np.argsort(first):
        yield int(gi), uniq[gi], grouped[starts[gi]:starts[gi + 1]]


def zipf_model_mix(exponent: float = 1.4) -> np.ndarray:
    """(M,) zipf-ish popularity over the served-model catalogue."""
    pop = 1.0 / np.arange(1, len(MODEL_NAMES) + 1) ** exponent
    return pop / pop.sum()


@dataclasses.dataclass
class TaskBatch:
    """Parallel per-task arrays (all length N; ``embeds`` is (N, E))."""

    ids: np.ndarray            # (N,) int64 globally unique task ids
    origin: np.ndarray         # (N,) int32 region index
    model_idx: np.ndarray      # (N,) int16 index into MODEL_NAMES
    kind_id: np.ndarray        # (N,) int8 index into state.KINDS
    work_s: np.ndarray         # (N,) float64 gpu-seconds (V100 reference)
    mem_gb: np.ndarray         # (N,) float64
    deadline_slot: np.ndarray  # (N,) int64
    arrival_slot: np.ndarray   # (N,) int64
    embeds: np.ndarray         # (N, E) float32 input embeddings (Eq 10)

    def __len__(self) -> int:
        return int(self.ids.shape[0])

    @property
    def embed_dim(self) -> int:
        return int(self.embeds.shape[1])

    def origin_counts(self, n_regions: int) -> np.ndarray:
        """(R,) arrival counts per region."""
        return np.bincount(self.origin, minlength=n_regions)[:n_regions]

    @classmethod
    def empty(cls, embed_dim: int = EMBED_DIM) -> "TaskBatch":
        z64 = np.zeros(0, np.int64)
        return cls(ids=z64, origin=np.zeros(0, np.int32),
                   model_idx=np.zeros(0, np.int16),
                   kind_id=np.zeros(0, np.int8),
                   work_s=np.zeros(0, np.float64),
                   mem_gb=np.zeros(0, np.float64),
                   deadline_slot=z64.copy(), arrival_slot=z64.copy(),
                   embeds=np.zeros((0, embed_dim), np.float32))

    @classmethod
    def concat(cls, *batches: "TaskBatch") -> "TaskBatch":
        parts = [b for b in batches if len(b)]
        if not parts:
            return batches[0] if batches else cls.empty()
        if len(parts) == 1:
            return parts[0]
        return cls(**{f.name: np.concatenate([getattr(b, f.name)
                                              for b in parts])
                      for f in dataclasses.fields(cls)})

    def select(self, idx: np.ndarray) -> "TaskBatch":
        """Row subset (fancy index or boolean mask)."""
        return TaskBatch(**{f.name: getattr(self, f.name)[idx]
                            for f in dataclasses.fields(self)})

    def to_tasks(self) -> List:
        """Legacy ``Task`` objects, one a row (the object path only)."""
        from repro_torch.workload.legacy import Task
        return [Task(id=int(self.ids[i]), origin=int(self.origin[i]),
                     model=MODEL_NAMES[int(self.model_idx[i])],
                     kind=KINDS[int(self.kind_id[i])],
                     work_s=float(self.work_s[i]),
                     mem_gb=float(self.mem_gb[i]),
                     deadline_slot=int(self.deadline_slot[i]),
                     arrival_slot=int(self.arrival_slot[i]),
                     embed=self.embeds[i])
                for i in range(len(self))]

    @classmethod
    def from_tasks(cls, tasks: Sequence,
                   embed_dim: int = EMBED_DIM) -> "TaskBatch":
        """Pack ``legacy.Task`` objects into arrays (tasks without an
        embedding get a zero row)."""
        n = len(tasks)
        if n == 0:
            return cls.empty(embed_dim)
        edim = next((t.embed.shape[0] for t in tasks
                     if t.embed is not None), embed_dim)
        embeds = np.zeros((n, edim), np.float32)
        for i, t in enumerate(tasks):
            if t.embed is not None:
                embeds[i] = t.embed
        return cls(
            ids=np.array([t.id for t in tasks], np.int64),
            origin=np.array([t.origin for t in tasks], np.int32),
            model_idx=np.array([model_id(t.model) for t in tasks], np.int16),
            kind_id=np.array([KIND_IDS[t.kind] for t in tasks], np.int8),
            work_s=np.array([t.work_s for t in tasks], np.float64),
            mem_gb=np.array([t.mem_gb for t in tasks], np.float64),
            deadline_slot=np.array([t.deadline_slot for t in tasks],
                                   np.int64),
            arrival_slot=np.array([t.arrival_slot for t in tasks], np.int64),
            embeds=embeds)
