"""SkyLB baseline [45] (port of ``repro/baselines/skylb.py``):
locality-aware cross-region load balancer.

Per-region local balancers prefer local processing; on saturation, spill to
the least-loaded remote region.  A prefix-tree-style affinity map pins
repeat (origin, model) pairs to fixed replicas to exploit cache locality —
adapted from SkyLB's session affinity to our model-serving setting.

Batch-native: tasks are grouped by (origin, model) — the affinity key —
and each group's work is placed with vectorized per-group operations: the
sticky phase fills the least-loaded live replica up to the 2-slot load bar
with a single cumulative-sum cutoff over the group's work array; replica
growth (local-first, then nearest unsaturated region) and the forced-spill
tail are one vectorized server pick per step.  The legacy ``schedule()``
entry is the deprecated shim through the batch path.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.api import BatchDecision, SlotDecision, schedule_via_batch
from repro_torch.sim.engine import SlotObs
from repro_torch.sim.state import ACTIVE
from repro_torch.workload.batch import group_rows


class SkyLBScheduler:
    name = "SkyLB"
    supports_batch = True

    def __init__(self, spill_threshold: float = 0.85):
        self.spill_threshold = spill_threshold
        self.reset()

    def reset(self) -> None:
        # (origin, model id) -> replica set of global server indices
        # (grown on saturation, like the prefix-tree fan-out in SkyLB)
        self.affinity: Dict[Tuple[int, int], List[int]] = {}

    def _pick_server(self, obs: SlotObs, ridx: int, mem_need: float,
                     mid: int, proj: Optional[np.ndarray] = None
                     ) -> Optional[int]:
        """Least-loaded eligible server of a region (global index), with
        the warm-replica bonus: a cache hit is worth the whole switch
        pipeline (~0.5 slot)."""
        st = obs.state
        sl = st.region_slice(ridx)
        ok = (st.state[sl] == ACTIVE) & (st.mem_gb[sl] >= mem_need)
        if not ok.any():
            return None
        load = st.queue_s[sl] / obs.slot_seconds
        if proj is not None:
            load = load + proj[sl] / obs.slot_seconds
        cur_hit = st.current_model[sl] == mid
        warm_hit = (st.warm_models[sl] == mid).any(axis=1) & ~cur_hit
        load = load - 2.0 * cur_hit - 0.8 * warm_hit
        load = np.where(ok, load, np.inf)
        best = int(np.argmin(load))
        return sl.start + best if np.isfinite(load[best]) else None

    def _region_saturated(self, obs: SlotObs, ridx: int) -> bool:
        st = obs.state
        sl = st.region_slice(ridx)
        act = st.state[sl] == ACTIVE
        if not act.any():
            return True
        mean_load = float(np.mean(st.queue_s[sl][act])) / obs.slot_seconds
        return mean_load > self.spill_threshold * 4.0

    def schedule_batch(self, obs: SlotObs, batch) -> BatchDecision:
        st = obs.state
        n = len(batch)
        out_region = np.full(n, -1, np.int32)
        out_server = np.full(n, -1, np.int32)
        if n == 0:
            return BatchDecision(region=out_region, server=out_server)
        r = st.n_regions
        slot_s = obs.slot_seconds
        speed = np.maximum(st.tflops / 112.0, 0.1)
        region_of = st.region_of
        region_ptr = st.region_ptr
        proj = np.zeros(st.n_servers)            # projected added seconds

        def emit(sel: np.ndarray, g: int) -> None:
            ridx = int(region_of[g])
            out_region[sel] = ridx
            out_server[sel] = g - int(region_ptr[ridx])

        # group by the affinity key (origin, model)
        keys = (batch.origin.astype(np.int64) * 4096
                + batch.model_idx.astype(np.int64))
        for _, _key, rows in group_rows(keys):
            origin = int(batch.origin[rows[0]])
            mid = int(batch.model_idx[rows[0]])
            mem_need = float(batch.mem_gb[rows[0]])
            reps = self.affinity.setdefault((origin, mid), [])
            works = batch.work_s[rows]
            k = 0
            while k < rows.size:
                # sticky phase: fill the least-loaded live replica up to
                # the 2-slot load bar (cumsum cutoff over group work)
                if reps:
                    g = np.asarray(reps)
                    live = st.state[g] == ACTIVE
                    loads = np.where(live, st.queue_s[g] + proj[g], np.inf)
                    b = int(np.argmin(loads))
                    if np.isfinite(loads[b]) and loads[b] < 2.0 * slot_s:
                        gb = int(g[b])
                        costs = works[k:] / speed[gb]
                        pre = loads[b] + np.concatenate(
                            ([0.0], np.cumsum(costs)[:-1]))
                        take = max(int(np.searchsorted(
                            pre, 2.0 * slot_s, side="left")), 1)
                        sel = rows[k:k + take]
                        emit(sel, gb)
                        proj[gb] += float(costs[:take].sum())
                        k += take
                        continue
                # grow replica set: local-first, then by latency
                order = [origin] + sorted(
                    (j for j in range(r) if j != origin),
                    key=lambda j: obs.latency[origin, j])
                gb = None
                for ridx in order:
                    if self._region_saturated(obs, ridx):
                        continue
                    gb = self._pick_server(obs, ridx, mem_need, mid, proj)
                    if gb is not None:
                        break
                if gb is not None:
                    if gb not in reps:
                        reps.append(gb)
                        del reps[8:]
                    emit(rows[k:k + 1], gb)
                    proj[gb] += float(works[k] / speed[gb])
                    k += 1
                    continue
                # forced spill: least-loaded region overall takes the tail
                loads_r = obs.queue_s / np.maximum(obs.capacities, 1e-9)
                ridx = int(np.argmin(loads_r))
                gb = self._pick_server(obs, ridx, mem_need, mid)
                if gb is not None:
                    sel = rows[k:]
                    emit(sel, gb)
                    proj[gb] += float((works[k:] / speed[gb]).sum())
                break
        return BatchDecision(region=out_region, server=out_server)

    def schedule(self, obs: SlotObs, tasks: List) -> SlotDecision:
        """Object-path shim over the batch contract."""
        return schedule_via_batch(self, obs, tasks)
