"""MILP formulation of single-slot allocation (port of
``repro/baselines/milp.py``; paper §III-A / Fig 5).

Variables: binary x[i, j] task->region-server-group assignment.
Objective : response-time proxy + power cost (the paper's simplified Fig-5
            configuration: 5 regions x 10 servers, 2 task types, dynamic
            server capacity 3-20 tasks, <=80% region concentration).
Solved with scipy's HiGHS MILP — used in the solve-time benchmark that
motivates the two-layer decomposition, and as an optional (tiny-instance)
scheduler oracle in tests.

:class:`MilpScheduler` is the engine-facing baseline on the unified batch
contract: because the per-task binary form explodes past ~1e3 tasks
(exactly the Fig-5 point), it solves the GROUP-level integer
transportation relaxation each slot — integer flows of (origin, kind)
task groups to regions under capacity and the <=80% concentration bound —
then places each region's share on least-loaded eligible servers with a
vectorized greedy.  Each slot's HiGHS status lands in ``statuses`` (0 =
optimal): the decisions are deterministic only where the solve ends
optimal within ``time_limit``."""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
from scipy.optimize import LinearConstraint, milp
from scipy.sparse import lil_matrix

from repro_torch.api import BatchDecision, SlotDecision, schedule_via_batch
from repro_torch.sim.state import ACTIVE
from repro_torch.workload.batch import group_rows


@dataclasses.dataclass
class MilpInstance:
    n_tasks: int
    n_units: int                 # region-server pairs (columns)
    cost: np.ndarray             # (n_tasks, n_units)
    capacity: np.ndarray         # (n_units,) tasks per unit
    region_of: np.ndarray        # (n_units,) region index
    n_regions: int
    region_cap_frac: float = 0.8


def make_instance(n_tasks: int, *, n_regions: int = 5,
                  servers_per_region: int = 10, seed: int = 0
                  ) -> MilpInstance:
    rng = np.random.default_rng(seed)
    n_units = n_regions * servers_per_region
    # two task types x unit affinity costs + regional power prices
    task_type = rng.integers(0, 2, n_tasks)
    unit_speed = rng.uniform(0.5, 2.0, n_units)
    region_price = rng.uniform(0.5, 2.0, n_regions)
    region_of = np.repeat(np.arange(n_regions), servers_per_region)
    base = rng.uniform(5, 20, (2, n_units)) / unit_speed
    cost = base[task_type] + region_price[region_of][None, :]
    capacity = rng.integers(3, 21, n_units).astype(float)
    return MilpInstance(n_tasks, n_units, cost, capacity, region_of,
                        n_regions)


def solve(instance: MilpInstance, *, time_limit: float = 300.0
          ) -> Dict[str, object]:
    """Returns dict(status, solve_time_s, objective, assignment)."""
    n, u = instance.n_tasks, instance.n_units
    nv = n * u
    c = instance.cost.reshape(-1)

    rows = []
    # each task assigned exactly once
    a = lil_matrix((n + u + instance.n_regions, nv))
    lb = np.zeros(n + u + instance.n_regions)
    ub = np.zeros_like(lb)
    for i in range(n):
        a[i, i * u:(i + 1) * u] = 1.0
        lb[i] = 1.0
        ub[i] = 1.0
    # unit capacity
    for j in range(u):
        a[n + j, j::u] = 1.0
        lb[n + j] = 0.0
        ub[n + j] = instance.capacity[j]
    # regional concentration <= 80% of tasks
    for r in range(instance.n_regions):
        cols = np.where(instance.region_of == r)[0]
        row = n + u + r
        for j in cols:
            a[row, j::u] = 1.0
        lb[row] = 0.0
        ub[row] = max(instance.region_cap_frac * n, 1.0)

    t0 = time.time()
    res = milp(c=c,
               constraints=LinearConstraint(a.tocsr(), lb, ub),
               integrality=np.ones(nv),
               bounds=(0, 1),
               options={"time_limit": time_limit})
    dt = time.time() - t0
    assignment = None
    if res.x is not None:
        assignment = res.x.reshape(n, u).argmax(1)
    return {"status": int(res.status), "success": bool(res.success),
            "solve_time_s": dt,
            "objective": float(res.fun) if res.fun is not None else None,
            "assignment": assignment}


# ---------------------------------------------------------------------------
# engine-facing scheduler (unified batch contract)
# ---------------------------------------------------------------------------


class MilpScheduler:
    """Per-slot MILP baseline over (origin, kind) task groups x regions."""

    def __init__(self, n_regions: int, *, time_limit: float = 2.0,
                 region_cap_frac: float = 0.8):
        self.n_regions = n_regions
        self.time_limit = time_limit
        self.region_cap_frac = region_cap_frac
        self.name = "MILP"
        self.statuses: List[int] = []

    def reset(self) -> None:
        self.statuses = []

    def _solve_counts(self, sizes: np.ndarray, cost: np.ndarray,
                      cap: np.ndarray) -> np.ndarray:
        """(G, R) integer flows: min-cost group->region counts under
        region capacity and the <=80% concentration bound; proportional
        fallback when the solver fails or the instance is infeasible."""
        g_n, r = cost.shape
        total = float(sizes.sum())
        nv = g_n * r
        a = lil_matrix((g_n + 2 * r, nv))
        lb = np.zeros(g_n + 2 * r)
        ub = np.zeros_like(lb)
        for gi in range(g_n):                    # each group fully routed
            a[gi, gi * r:(gi + 1) * r] = 1.0
            lb[gi] = ub[gi] = sizes[gi]
        for j in range(r):                       # region capacity
            a[g_n + j, j::r] = 1.0
            ub[g_n + j] = cap[j]
        for j in range(r):                       # concentration <= 80%
            a[g_n + r + j, j::r] = 1.0
            ub[g_n + r + j] = max(self.region_cap_frac * total, 1.0)
        res = milp(c=cost.reshape(-1),
                   constraints=LinearConstraint(a.tocsr(), lb, ub),
                   integrality=np.ones(nv), bounds=(0, total),
                   options={"time_limit": self.time_limit})
        self.statuses.append(int(res.status))
        if res.x is not None and res.success:
            return np.rint(res.x.reshape(g_n, r)).astype(np.int64)
        # fallback: proportional-to-capacity split (largest remainders)
        share = cap / max(cap.sum(), 1e-9)
        counts = np.floor(sizes[:, None] * share[None, :]).astype(np.int64)
        for gi in range(g_n):
            rest = int(sizes[gi]) - int(counts[gi].sum())
            if rest > 0:
                frac = sizes[gi] * share - counts[gi]
                counts[gi, np.argsort(-frac)[:rest]] += 1
        return counts

    def schedule_batch(self, obs, batch) -> BatchDecision:
        st = obs.state
        n = len(batch)
        r = self.n_regions
        out_region = np.full(n, -1, np.int32)
        out_server = np.full(n, -1, np.int32)
        if n == 0:
            return BatchDecision(region=out_region, server=out_server)

        keys = batch.origin.astype(np.int64) * 8 + batch.kind_id
        uniq, inverse = np.unique(keys, return_inverse=True)
        g_n = uniq.size
        sizes = np.bincount(inverse, minlength=g_n).astype(np.float64)
        mean_work = np.bincount(inverse, weights=batch.work_s,
                                minlength=g_n) / sizes
        g_origin = (uniq // 8).astype(np.int64)

        # region facts: mean active speed, free capacity, price, latency
        act = st.state == ACTIVE
        speed = np.maximum(st.tflops / 112.0, 0.1)
        reg_speed = np.ones(r)
        for j in range(r):
            sl = st.region_slice(j)
            m = act[sl]
            if m.any():
                reg_speed[j] = float(np.mean(speed[sl][m]))
        free = np.maximum(obs.capacities - obs.queue_tasks, 0.0)
        # keep the instance feasible: scale capacities to cover demand
        cap = np.maximum(free, 1e-3)
        cap = np.ceil(cap * max(1.0, 1.1 * n / cap.sum()))
        cost = (mean_work[:, None] / reg_speed[None, :]
                + obs.latency[g_origin] / 1000.0
                + obs.power_prices[None, :] * 2.0)
        counts = self._solve_counts(sizes, cost, cap)

        # place each region's share on least-loaded eligible servers
        proj = np.zeros(st.n_servers)
        for gi, _key, rows in group_rows(keys):
            k = 0
            for j in np.argsort(cost[gi], kind="stable"):
                c_j = int(counts[gi, j])
                if c_j <= 0:
                    continue
                sel = rows[k:k + c_j]
                k += c_j
                sl = st.region_slice(j)
                ok = act[sl]
                for i in sel:
                    elig = ok & (st.mem_gb[sl] >= batch.mem_gb[i])
                    if not elig.any():
                        continue               # buffer this task
                    load = np.where(elig, st.queue_s[sl] + proj[sl],
                                    np.inf)
                    best = int(np.argmin(load))
                    proj[sl.start + best] += \
                        batch.work_s[i] / speed[sl.start + best]
                    out_region[i] = j
                    out_server[i] = best
        return BatchDecision(region=out_region, server=out_server)

    def schedule(self, obs, tasks: List) -> SlotDecision:
        """Object-path shim over the batch contract."""
        return schedule_via_batch(self, obs, tasks)
