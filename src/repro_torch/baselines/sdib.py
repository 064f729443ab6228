"""SDIB baseline (port of ``repro/baselines/sdib.py``; Standard Deviation
and Idle-time Balanced), following the
MERL-LB [49] multi-objective principles: minimize the std-dev of server load
and the mean GPU idle time.  Greedy: each task goes to the (region, server)
that minimizes the projected load variance + idle penalty.

Batch-native: consumes ``TaskBatch`` arrays directly (no Task objects);
per-task candidate scoring is one vectorized pass over the global
struct-of-arrays fleet, with the loop-invariant region ranking, per-origin
candidate masks, and the active-load mean all hoisted/maintained
incrementally instead of recomputed per task.  The legacy ``schedule()``
entry is the deprecated shim through the batch path.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.api import BatchDecision, SlotDecision, schedule_via_batch
from repro_torch.sim.engine import SlotObs
from repro_torch.sim.state import ACTIVE


class SDIBScheduler:
    name = "SDIB"
    supports_batch = True

    def __init__(self, idle_weight: float = 0.3, sample_regions: int = 6):
        self.idle_weight = idle_weight
        self.sample_regions = sample_regions

    def reset(self) -> None:
        pass

    def schedule_batch(self, obs: SlotObs, batch) -> BatchDecision:
        st = obs.state
        n = len(batch)
        out_region = np.full(n, -1, np.int32)
        out_server = np.full(n, -1, np.int32)
        act = st.state == ACTIVE
        if n == 0 or not act.any():
            return BatchDecision(region=out_region, server=out_server)
        # running copy of projected server loads
        loads = st.queue_s.astype(np.float64)
        region_of = st.region_of
        region_ptr = st.region_ptr
        speed = np.maximum(st.tflops / 112.0, 0.1)
        # candidate regions: loop-invariant within a slot (obs arrays are
        # the slot snapshot) — origin region + least-loaded few regions
        reg_load = obs.queue_s / np.maximum(obs.capacities, 1e-9)
        cand_base = np.zeros(st.n_regions, bool)
        cand_base[np.argsort(reg_load)[: self.sample_regions]] = True
        cand_cache = {}
        act_sum = float(loads[act].sum())        # incremental load mean
        act_n = int(np.count_nonzero(act))
        idle_term = (self.idle_weight * st.idle_slots.astype(np.float64)
                     * obs.slot_seconds * 0.1)
        for i in range(n):
            origin = int(batch.origin[i])
            cand = cand_cache.get(origin)
            if cand is None:
                cr = cand_base.copy()
                cr[origin] = True
                cand = act & cr[region_of]
                cand_cache[origin] = cand
            eligible = cand & (st.mem_gb >= batch.mem_gb[i])
            if not eligible.any():
                continue
            mean = act_sum / act_n
            dl = batch.work_s[i] / speed
            # projected deviation from mean + idle-time pressure:
            # prefer servers that have been idle (reduces mean idle time)
            score = np.abs(loads + dl - mean) - idle_term
            # cache-aware tie-break (paper §VI-C2: SDIB is cache-aware)
            score = score - 0.5 * obs.slot_seconds * (
                st.current_model == batch.model_idx[i])
            score = np.where(eligible, score, np.inf)
            best = int(np.argmin(score))
            act_sum += float(dl[best])           # best is active
            loads[best] += dl[best]
            idle_term[best] = 0.0                # just-used server: no idle
            ridx = int(region_of[best])
            out_region[i] = ridx
            out_server[i] = best - int(region_ptr[ridx])
        return BatchDecision(region=out_region, server=out_server)

    def schedule(self, obs: SlotObs, tasks: List) -> SlotDecision:
        """Object-path shim over the batch contract."""
        return schedule_via_batch(self, obs, tasks)
