"""Torch engine slot step (port of ``repro/sim/engine_jax.py``).

``TorchStep`` is a dataclass-of-tensors view of ``ClusterState``'s
dynamic columns plus the static hardware facts the step math needs.
Three functions cover the engine's whole-array surface:

* :func:`warm_step` — warming progression;
* :func:`apply_single` — the grouped decision apply for servers that
  receive exactly ONE task this slot (switch cost + energy, MRU update,
  queue push, wait/work channels);
* :func:`close_step` — queue drain, utilization/idle bookkeeping and the
  per-server power draw.

Every op is float64 and elementwise in the numpy engine's expression
order, one eager torch op at a time, so nothing contracts into an FMA
and the results are bitwise those of ``Engine(step_backend="numpy")``.
Reductions (per-region power, metric totals) stay on the host over the
returned arrays, as in the reference.  The reference pads its row
channels to shape buckets and scatters with ``mode="drop"``; eager torch
has no compiled shapes, so the rows are indexed directly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.obs import runtime as obs_rt
from repro_torch.sim.cluster import MODEL_SWITCH_S, SWITCH_POWER_FRAC
from repro_torch.sim.state import (_WARM_HIT_S, ACTIVE, NO_MODEL, WARM_SLOTS,
                                   WARMING, ClusterState)

_DYNAMIC = ("state", "warm_remaining_s", "queue_s", "util", "idle_slots",
            "current_model", "warm_models")


@dataclasses.dataclass
class TorchStep:
    """Tensor view of ``ClusterState`` for the torch slot step."""

    # dynamic columns (written back after each step)
    state: torch.Tensor             # (S,) int8
    warm_remaining_s: torch.Tensor  # (S,) float64
    queue_s: torch.Tensor           # (S,) float64
    util: torch.Tensor              # (S,) float64
    idle_slots: torch.Tensor        # (S,) int64
    current_model: torch.Tensor     # (S,) int16
    warm_models: torch.Tensor       # (S, W) int16
    # static hardware facts.  ``speed`` is max(tflops/112, 0.1) computed
    # with host numpy, the numpy engine's own true division.
    speed: torch.Tensor             # (S,) float64
    power_w: torch.Tensor           # (S,) float64
    switch_scale: torch.Tensor      # (S,) float64

    @classmethod
    def from_state(cls, st: ClusterState, statics) -> "TorchStep":
        """Upload the dynamic columns next to the cached static triple
        ``(speed, power_w, switch_scale)``."""
        dev = statics[0].device
        cols = {name: torch.from_numpy(getattr(st, name)).to(dev)
                for name in _DYNAMIC}
        speed, power_w, switch_scale = statics
        return cls(speed=speed, power_w=power_w, switch_scale=switch_scale,
                   **cols)

    def write_back(self, st: ClusterState, fields=_DYNAMIC) -> None:
        """Sync the named columns into the numpy ``ClusterState``."""
        for name in fields:
            getattr(st, name)[...] = getattr(self, name).cpu().numpy()


def warm_step(step: TorchStep, slot_s: float) -> TorchStep:
    """Warming servers progress toward ACTIVE."""
    warming = step.state == WARMING
    rem = torch.where(warming, step.warm_remaining_s - slot_s,
                      step.warm_remaining_s)
    done = warming & (rem <= 0)
    return dataclasses.replace(
        step,
        state=torch.where(done, torch.tensor(ACTIVE, dtype=torch.int8,
                                             device=rem.device), step.state),
        warm_remaining_s=torch.where(done, 0.0, rem))


def apply_single(step: TorchStep, gs: torch.Tensor, mids: torch.Tensor,
                 work_raw: torch.Tensor):
    """Grouped apply for DISTINCT servers ``gs`` receiving one task each.
    Returns the updated step plus per-row (switch s, energy J, wait s,
    work s)."""
    speed = step.speed[gs]
    scale = step.switch_scale[gs]
    rows = step.warm_models[gs]                       # (K, W) int16
    mids16 = mids.to(rows.dtype)
    warm_hit = (rows == mids16[:, None]).any(dim=1)
    cost = torch.where(warm_hit, scale * _WARM_HIT_S, scale * MODEL_SWITCH_S)
    sw = torch.where(step.current_model[gs] == mids16, 0.0, cost)
    energy = torch.where(sw > 0, sw * step.power_w[gs] * SWITCH_POWER_FRAC,
                         0.0)
    wk = work_raw / speed
    wait = step.queue_s[gs] + sw

    # MRU model-cache update (``ClusterState.note_model_rows``)
    keep = (rows != mids16[:, None]) & (rows != NO_MODEL)
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    kept = torch.gather(rows, 1, order)
    n_keep = keep.sum(dim=1)
    no_model = torch.full_like(mids16, NO_MODEL)
    cols = [mids16] + [torch.where(n_keep > k, kept[:, k], no_model)
                       for k in range(WARM_SLOTS - 1)]

    queue = step.queue_s.clone()
    queue[gs] += sw + wk
    current = step.current_model.clone()
    current[gs] = mids16
    warm = step.warm_models.clone()
    warm[gs] = torch.stack(cols, dim=1)
    step = dataclasses.replace(step, queue_s=queue, current_model=current,
                               warm_models=warm)
    return step, sw, energy, wait, wk


def close_step(step: TorchStep, slot_s: float):
    """Queue drain + utilization/idle bookkeeping + per-server power draw.
    Returns the updated step, the power draw (J) and the active mask."""
    act = step.state == ACTIVE
    busy = torch.clamp(step.queue_s, max=slot_s)
    util = torch.where(act, busy / slot_s, step.util)
    idle = torch.where(act, torch.where(util > 0.05, 0, step.idle_slots + 1),
                       step.idle_slots)
    queue = torch.where(act, torch.clamp(step.queue_s - slot_s, min=0.0),
                        step.queue_s)
    power_j = torch.where(act, (0.1 + 0.9 * util) * step.power_w * slot_s,
                          0.0)
    return dataclasses.replace(step, queue_s=queue, util=util,
                               idle_slots=idle), power_j, act


class TorchStepper:
    """Host-side runner: builds the ``TorchStep`` view on ``device``, runs
    one step function and writes the columns it changed back into the
    numpy ``ClusterState`` mirror.  The static triple is uploaded once."""

    def __init__(self, state: ClusterState, device: torch.device):
        self.state = state
        self.device = device
        self._static = None

    def _make_step(self) -> TorchStep:
        if self._static is None:
            st = self.state
            self._static = tuple(
                torch.from_numpy(a).to(self.device)
                for a in (np.maximum(st.tflops / 112.0, 0.1), st.power_w,
                          st.switch_scale))
        return TorchStep.from_state(self.state, self._static)

    def progress_warming(self, slot_s: float) -> None:
        st = self.state
        if not (st.state == WARMING).any():
            return
        obs_rt.count("engine.host_sync.warm_step")
        warm_step(self._make_step(), slot_s).write_back(
            st, fields=("state", "warm_remaining_s"))

    def apply_single_rows(self, gs: np.ndarray, mids: np.ndarray,
                          work_raw: np.ndarray):
        """Apply one task to each distinct server ``gs[k]``; returns
        (switch s, energy J, wait s, work s) per row as numpy."""
        obs_rt.count("engine.host_sync.apply_single")
        dev = self.device
        step, sw, energy, wait, wk = apply_single(
            self._make_step(), torch.from_numpy(gs.astype(np.int64)).to(dev),
            torch.from_numpy(mids.astype(np.int64)).to(dev),
            torch.from_numpy(work_raw.astype(np.float64)).to(dev))
        step.write_back(self.state,
                        fields=("queue_s", "current_model", "warm_models"))
        return tuple(a.cpu().numpy() for a in (sw, energy, wait, wk))

    def close_slot(self, slot_s: float):
        """Drain/bill the slot; returns the per-server power draw (J) and
        active mask for the host-side regional reduction."""
        obs_rt.count("engine.host_sync.close_step")
        step, power_j, act = close_step(self._make_step(), slot_s)
        step.write_back(self.state, fields=("queue_s", "util", "idle_slots"))
        return power_j.cpu().numpy(), act.cpu().numpy()
