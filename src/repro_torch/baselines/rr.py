"""Round-Robin baseline (port of ``repro/baselines/rr.py``; paper §VI-A):
round-robin over regions and over
servers within each region, "while maintaining necessary capacity and
compatibility constraints" — compatibility includes the loaded model:
rotation happens within per-model replica pools, growing a pool only when
its replicas are saturated (otherwise a literal per-task rotation would
strawman the baseline with a model switch per task).

Batch-native: tasks of one model are dealt over the model's replica pool
in vectorized ROUNDS — each round distributes up to one task per
unsaturated pool replica (rotation resuming at the model's pointer), so
the per-slot work is O(rounds x pool) array operations instead of a
per-Task Python loop.  All tasks of one model share a memory footprint,
so eligibility (active + memory + saturation) is a single mask per round.
The legacy ``schedule()`` entry is the deprecated shim through the batch
path.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.api import BatchDecision, SlotDecision, schedule_via_batch
from repro_torch.sim.engine import SlotObs
from repro_torch.sim.state import ACTIVE
from repro_torch.workload.batch import group_rows


class RoundRobinScheduler:
    name = "RR"
    supports_batch = True

    def __init__(self, saturation_slots: float = 2.0):
        self.saturation_slots = saturation_slots
        self.reset()

    def reset(self) -> None:
        self._r = 0
        self._ptr: Dict[int, int] = {}
        self.pools: Dict[int, List[int]] = {}    # model id -> global servers

    def _grow_pool(self, st, mid: int, mem_need: float) -> bool:
        """Add the next server (region round-robin) to the model's pool."""
        r = st.n_regions
        pool = self.pools.setdefault(mid, [])
        taken = set(pool)
        for _ in range(r):
            ridx = self._r % r
            self._r += 1
            sl = st.region_slice(ridx)
            ok = (st.state[sl] == ACTIVE) & (st.mem_gb[sl] >= mem_need)
            for sidx in np.flatnonzero(ok):
                g = sl.start + int(sidx)
                if g in taken:
                    continue
                pool.append(g)
                return True
        return False

    def schedule_batch(self, obs: SlotObs, batch) -> BatchDecision:
        st = obs.state
        n = len(batch)
        out_region = np.full(n, -1, np.int32)
        out_server = np.full(n, -1, np.int32)
        if n == 0:
            return BatchDecision(region=out_region, server=out_server)
        sat = self.saturation_slots * obs.slot_seconds
        proj = np.zeros(st.n_servers)            # projected added seconds
        speed = np.maximum(st.tflops / 112.0, 0.1)
        region_of = st.region_of
        region_ptr = st.region_ptr

        for _, key, rows in group_rows(batch.model_idx):
            mid = int(key)
            mem_need = float(batch.mem_gb[rows[0]])  # constant per model
            pool = self.pools.setdefault(mid, [])
            k = 0
            while k < rows.size:
                if not pool:
                    if not self._grow_pool(st, mid, mem_need):
                        break
                g = np.asarray(pool)
                eligible = ((st.state[g] == ACTIVE)
                            & (st.mem_gb[g] >= mem_need)
                            & (st.queue_s[g] + proj[g] <= sat))
                if not eligible.any():
                    if not self._grow_pool(st, mid, mem_need):
                        break
                    continue
                # one dealing round: rotate the eligible replicas starting
                # at the model's pointer, hand each the next task
                p0 = self._ptr.get(mid, 0) % len(pool)
                order = np.flatnonzero(np.roll(eligible, -p0))
                targets = g[(order + p0) % len(pool)]
                take = min(rows.size - k, targets.size)
                sel = rows[k:k + take]
                sel_g = targets[:take]
                reg = region_of[sel_g]
                out_region[sel] = reg
                out_server[sel] = sel_g - region_ptr[reg]
                np.add.at(proj, sel_g, batch.work_s[sel] / speed[sel_g])
                self._ptr[mid] = int((order[take - 1] + p0) % len(pool)) + 1
                k += take
        return BatchDecision(region=out_region, server=out_server)

    def schedule(self, obs: SlotObs, tasks: List) -> SlotDecision:
        """Object-path shim over the batch contract."""
        return schedule_via_batch(self, obs, tasks)
