"""Micro-level allocation (§V-C), port of ``repro/core/micro.py``: dynamic
server activation (Eq 6) + greedy task-server matching by compatibility
score (Eqs 7-10) + task buffering.

Only the fused route is ported: ONE multi-region greedy per slot
(``core/micro_torch.py``, the hand-written kernel on the card) with the
locality rings kept on the device across slots.  The Eq-6 activation
targets stay host arithmetic, as in the reference.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.micro_state import LocalityState
from repro_torch.core.micro_torch import DeviceRings, assign_scan_all
from repro_torch.obs import runtime as obs_rt
from repro_torch.sim.state import MODEL_NAMES

W_HW, W_LOAD, W_LOC = 0.4, 0.4, 0.2      # Eq 7 weights
W_WARM = 2.0                             # same-model (no-switch) bonus
W_MODEL, W_EMBED = 0.7, 0.3              # Eq 10 similarity weights
LOC_DECAY = 0.5                          # lambda in Eq 10

# compute requirement proxy: task kind maps to a tflops demand (Eq 8)
DEMAND_TFLOPS = {"compute": 200.0, "memory": 100.0, "lightweight": 60.0}
KIND_ORDER = ("compute", "memory", "lightweight")
_DEMAND_BY_KIND = np.array([DEMAND_TFLOPS[k] for k in KIND_ORDER])

# model-id -> lexicographic rank of the model name, so the greedy order
# (deadline, model name, -work) is one np.lexsort over ids
_MODEL_RANK = np.empty(len(MODEL_NAMES), np.int64)
_MODEL_RANK[np.argsort(np.array(MODEL_NAMES))] = np.arange(len(MODEL_NAMES))


def target_active_servers(queue_tasks: float, predicted: float,
                          avg_capacity: float, n_servers: int, *,
                          sigma: float = 1.0, headroom: float = 2.0) -> int:
    """Eq 6: N_target = min(S_r, ceil((Q + F + sigma*sqrt(F)) / C_avg)),
    scaled by ``headroom``."""
    f = max(predicted, 0.0)
    need = (queue_tasks + f + sigma * math.sqrt(f)) / max(avg_capacity, 1e-9)
    return int(min(n_servers, max(1, math.ceil(headroom * need))))


class MicroAllocator:
    """Urgency-first greedy matching (Algorithm 1, Phase 2) of every
    region of a slot in one fused greedy on ``device``."""

    KEEP = 4                      # locality history depth

    def __init__(self, sigma: float = 1.0, headroom: float = 2.0, *,
                 device="cuda"):
        self.sigma = sigma
        self.headroom = headroom
        self.device = resolve_device(device)
        self.reset()

    def reset(self) -> None:
        self._dev_rings: Optional[DeviceRings] = None
        self._dev_region_sizes = None

    def locality_state(self, ridx: int) -> Optional[LocalityState]:
        """The region's rings as host arrays (None before first use)."""
        if self._dev_rings is None:
            return None
        return self._dev_rings.region_state(ridx,
                                            self._dev_region_sizes[ridx])

    def _ensure_dev_rings(self, n_regions: int, s_pad: int,
                          edim: int) -> DeviceRings:
        """Device rings (grown in the embed channel on demand, reset when
        the fleet shape moves)."""
        rings = self._dev_rings
        if rings is None or rings.mids.shape[:2] != (n_regions, s_pad):
            rings = DeviceRings.empty(n_regions, s_pad, self.KEEP,
                                      max(edim, 1), self.device)
        elif rings.embed_dim < edim:
            rings = rings.grown(edim)
        self._dev_rings = rings
        return rings

    def activation_target(self, obs, ridx: int, predicted: float) -> int:
        st = obs.state
        sl = st.region_slice(ridx)
        caps = st.capacity[sl]
        avg_cap = float(np.mean(caps)) if caps.size else 1.0
        return target_active_servers(
            float(obs.queue_tasks[ridx]), predicted, avg_cap,
            sl.stop - sl.start, sigma=self.sigma, headroom=self.headroom)

    def activation_targets(self, obs, pred_inbound: np.ndarray) -> np.ndarray:
        """All regions' Eq-6 targets as one ``(R,)`` array."""
        r = obs.state.n_regions
        out = np.empty(r, np.int64)
        for j in range(r):
            out[j] = self.activation_target(obs, j, float(pred_inbound[j]))
        return out

    def assign_batch_all(self, obs, batch, region_of: np.ndarray) -> np.ndarray:
        """Assign EVERY routed row of the slot's ``TaskBatch`` in one
        multi-region greedy.  ``region_of`` is the phase-1 target region
        per row (-1 = unrouted); returns the server-in-region per row
        (-1 = buffer)."""
        region_of = np.asarray(region_of)
        out = np.full(len(batch), -1, np.int32)
        rows = np.flatnonzero(region_of >= 0)
        if rows.size == 0:
            return out
        self._dev_region_sizes = obs.state.region_sizes()
        with obs_rt.span("micro.assign"):
            # one global sort: region-major, then each region's greedy
            # order (deadline, model name, -work)
            work = batch.work_s[rows]
            order = np.lexsort((-work, _MODEL_RANK[batch.model_idx[rows]],
                                batch.deadline_slot[rows],
                                region_of[rows]))
            sidx = rows[order]
            embeds = batch.embeds[sidx]
            norms = np.linalg.norm(embeds, axis=1)
            out[sidx] = assign_scan_all(
                self, obs, region_of[sidx],
                mem_t=batch.mem_gb[sidx], work=work[order],
                mids=batch.model_idx[sidx].astype(np.int16),
                kind_ids=batch.kind_id[sidx], embeds=embeds,
                # a zero row is TaskBatch's encoding of "no embedding"
                has_embed=norms > 0.0, norms=norms)
        return out

    def _assign_core(self, obs, ridx: int, *, mem_t: np.ndarray,
                     work: np.ndarray, mids: np.ndarray,
                     kind_ids: np.ndarray, embeds: np.ndarray,
                     has_embed: np.ndarray,
                     norms: np.ndarray) -> np.ndarray:
        """One region's pre-sorted tasks through the same fused greedy and
        device rings; returns per-task server index (-1 = buffer)."""
        self._dev_region_sizes = obs.state.region_sizes()
        return assign_scan_all(
            self, obs, np.full(len(work), ridx, np.int64), mem_t=mem_t,
            work=work, mids=mids, kind_ids=kind_ids, embeds=embeds,
            has_embed=has_embed, norms=norms)
