"""The scheduling contract: ``schedule_batch`` over ``TaskBatch`` (port of
``repro/api/contract.py``).

A :class:`BatchDecision` is two int32 channels parallel to the slot's
``TaskBatch`` rows (``region[i] == -1`` buffers task ``i``) plus an
optional per-region activation channel (Eq 6 targets), given as a
``{region: n_active}`` dict or an ``(R,)`` array where a negative entry
means "no target".  Channels may be torch tensors (on any device);
:meth:`BatchDecision.to_host` is their one sync point.

:class:`SlotDecision` (the per-task-id dict of legacy ``schedule()``
methods) survives for the adapter: :func:`schedule_via_batch` lets a
``schedule()`` method delegate to the batch path in one line, and the two
conversion helpers translate decisions between the shapes.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Dict, List, Optional, Protocol, Tuple, Union,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch.obs import runtime as obs_rt

ActivationLike = Union[None, Dict[int, int], np.ndarray, torch.Tensor]


def _as_index_array(value, name: str):
    """Coerce a decision channel to a 1-D int32 array; tensors stay on
    their device (no sync at construction)."""
    if isinstance(value, torch.Tensor):
        if value.ndim != 1:
            raise ValueError(f"BatchDecision.{name} must be 1-D, "
                             f"got shape {tuple(value.shape)}")
        return value.to(torch.int32)
    arr = np.asarray(value)
    if arr.ndim != 1:
        raise ValueError(f"BatchDecision.{name} must be 1-D, "
                         f"got shape {arr.shape}")
    return arr.astype(np.int32, copy=False)


@dataclasses.dataclass
class BatchDecision:
    """Array-native decision over one slot's ``TaskBatch``."""

    region: np.ndarray               # (N,) int32 target region, -1 = buffer
    server: np.ndarray               # (N,) int32 server index within region
    # per-region activation targets (Eq 6): (R,) array (<0 = no target)
    # or a {region: n_active} dict
    activation: ActivationLike = None

    def __post_init__(self):
        self.region = _as_index_array(self.region, "region")
        self.server = _as_index_array(self.server, "server")

    def __len__(self) -> int:
        return int(self.region.shape[0])

    def activation_targets(self, n_regions: int) -> Optional[Dict[int, int]]:
        """Normalize the activation channel to a ``{region: target}`` dict
        (regions with a negative array entry are omitted)."""
        act = self.activation
        if act is None:
            return None
        if isinstance(act, dict):
            return {int(k): int(v) for k, v in act.items()}
        arr = np.asarray(act)
        if arr.shape != (n_regions,):
            raise ValueError(
                f"BatchDecision.activation array must have shape "
                f"({n_regions},), got {arr.shape}")
        return {j: int(v) for j, v in enumerate(arr) if v >= 0}

    def to_host(self) -> "BatchDecision":
        """Materialize tensor channels as host numpy (in place); returns
        self."""
        synced = False
        for name in ("region", "server", "activation"):
            value = getattr(self, name)
            if isinstance(value, torch.Tensor):
                setattr(self, name, value.cpu().numpy())
                synced = True
        if synced:
            obs_rt.count("decision.host_sync")
        return self

    def validate(self, n_tasks: int, state) -> "BatchDecision":
        """Shape/range validation against a ``ClusterState``: both channels
        length ``n_tasks``; regions in ``[-1, R)``; assigned rows name an
        existing server of their region.  Returns self."""
        self.to_host()
        for name in ("region", "server"):
            got = getattr(self, name).shape[0]
            if got != n_tasks:
                raise ValueError(
                    f"BatchDecision.{name} has length {got}, expected "
                    f"{n_tasks} (one row per task in the batch)")
        r = state.n_regions
        if n_tasks:
            rmin, rmax = int(self.region.min()), int(self.region.max())
            if rmin < -1 or rmax >= r:
                raise ValueError(
                    f"BatchDecision.region values must lie in [-1, {r}), "
                    f"got range [{rmin}, {rmax}]")
            mask = self.region >= 0
            if mask.any():
                srv = self.server[mask]
                limit = state.region_sizes()[self.region[mask]]
                bad = np.flatnonzero((srv < 0) | (srv >= limit))
                if bad.size:
                    raise ValueError(
                        "BatchDecision.server out of range for its target "
                        f"region (e.g. server={int(srv[bad[0]])} in a "
                        f"region of {int(limit[bad[0]])} servers)")
        if isinstance(self.activation, dict):
            for k in self.activation:
                if not 0 <= int(k) < r:
                    raise ValueError(
                        f"BatchDecision.activation region {k} outside "
                        f"[0, {r})")
        elif self.activation is not None:
            self.activation_targets(r)      # shape check
        return self


@dataclasses.dataclass
class SlotDecision:
    """Object-path decision shape (kept for the adapter and legacy code):
    ``task.id -> (region, server-in-region)``, ``None`` = buffer."""

    assignments: Dict[int, Optional[Tuple[int, int]]]
    activation: Optional[Dict[int, int]] = None


@runtime_checkable
class Scheduler(Protocol):
    """The one scheduling contract the engine drives."""

    name: str

    def reset(self) -> None: ...

    def schedule_batch(self, obs: Any, batch: Any) -> BatchDecision: ...


# ---------------------------------------------------------------------------
# decision conversions (adapter + legacy shims)
# ---------------------------------------------------------------------------


def batch_to_slot_decision(decision: BatchDecision, batch) -> SlotDecision:
    """``BatchDecision`` -> per-task-id ``SlotDecision`` (rows are keyed by
    the batch's task ids)."""
    decision.to_host()
    region, server, ids = decision.region, decision.server, batch.ids
    assignments: Dict[int, Optional[Tuple[int, int]]] = {}
    for i in range(len(batch)):
        ridx = int(region[i])
        assignments[int(ids[i])] = ((ridx, int(server[i]))
                                    if ridx >= 0 else None)
    activation = decision.activation
    if activation is not None and not isinstance(activation, dict):
        activation = decision.activation_targets(
            np.asarray(activation).shape[0])
    return SlotDecision(assignments=assignments, activation=activation)


def slot_to_batch_decision(decision: SlotDecision, batch) -> BatchDecision:
    """``SlotDecision`` -> ``BatchDecision`` over ``batch``'s rows (tasks
    missing from the assignment dict are buffered)."""
    n = len(batch)
    region = np.full(n, -1, np.int32)
    server = np.full(n, -1, np.int32)
    get = decision.assignments.get
    ids = batch.ids
    for i in range(n):
        tgt = get(int(ids[i]))
        if tgt is not None:
            region[i], server[i] = int(tgt[0]), int(tgt[1])
    return BatchDecision(region=region, server=server,
                         activation=decision.activation)


def schedule_via_batch(scheduler: Scheduler, obs, tasks: List) -> SlotDecision:
    """``schedule()`` shim: pack legacy ``Task`` objects into a
    ``TaskBatch``, run the batch path, translate back."""
    from repro_torch.workload.batch import TaskBatch
    batch = TaskBatch.from_tasks(tasks)
    return batch_to_slot_decision(scheduler.schedule_batch(obs, batch), batch)
