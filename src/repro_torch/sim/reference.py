"""Frozen object-per-server simulation reference (golden-parity oracle),
port of ``repro/sim/reference.py``.

This module preserves the pre-refactor semantics verbatim: an engine that
iterates Python ``Server`` objects, a micro allocator that scores each
(task, server) pair with the scalar Eq 7-10 functions, and the original
round-robin baseline.  It exists for two purposes only:

* the parity tests pin the port's array engine (``sim/engine.py``) to
  this implementation on seeded configurations (same completions, drops,
  power cost, switch counts);
* ``chip_smoke.py``'s ``[golden]`` phase does the same on the card and
  measures the array engine's slot time against this per-object one.

Everything here is host Python over objects, as in the reference, except
the phase-1 plan of ``make_reference_torta``'s scheduler, which is the
port's ``TortaScheduler`` on ``device`` (Sinkhorn on the card there).

Do not add features here — new work goes into the array engine.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.api import SlotDecision
from repro_torch.core.micro import LocalityTracker, score, target_active_servers
from repro_torch.sim.cluster import COLD_START_S, SWITCH_POWER_FRAC, Cluster
from repro_torch.sim.metrics import MetricsAggregator
from repro_torch.sim.topology import Topology
from repro_torch.workload import Task, Workload, to_legacy_workload


@dataclasses.dataclass
class RefSlotObs:
    """Old-shape observation: carries the object ``Cluster``."""
    t: int
    latency: np.ndarray
    capacities: np.ndarray
    total_capacities: np.ndarray
    queue_s: np.ndarray
    queue_tasks: np.ndarray
    utilization: np.ndarray
    power_prices: np.ndarray
    prev_alloc: np.ndarray
    arrivals_history: np.ndarray
    cluster: Cluster
    slot_seconds: float


class ReferenceMicroAllocator:
    """Pre-refactor greedy matcher: nested per-task x per-server loops."""

    def __init__(self, sigma: float = 1.0, headroom: float = 2.0):
        self.sigma = sigma
        self.headroom = headroom
        self.loc = LocalityTracker()

    def reset(self) -> None:
        self.loc = LocalityTracker()

    def activation_target(self, obs: RefSlotObs, ridx: int,
                          predicted: float) -> int:
        reg = obs.cluster.regions[ridx]
        caps = [s.capacity for s in reg.servers]
        avg_cap = float(np.mean(caps)) if caps else 1.0
        return target_active_servers(
            float(obs.queue_tasks[ridx]), predicted, avg_cap,
            len(reg.servers), sigma=self.sigma, headroom=self.headroom)

    def assign_region(self, obs: RefSlotObs, ridx: int, tasks: List[Task]
                      ) -> Dict[int, Optional[Tuple[int, int]]]:
        reg = obs.cluster.regions[ridx]
        active = [(i, s) for i, s in enumerate(reg.servers)
                  if s.state == "active"]
        out: Dict[int, Optional[Tuple[int, int]]] = {}
        if not active:
            return {t.id: None for t in tasks}
        ordered = sorted(tasks,
                         key=lambda tk: (tk.deadline_slot, tk.model,
                                         -tk.work_s))
        proj = {i: s.queue_s for i, s in active}
        for task in ordered:
            best, best_sc = None, -float("inf")
            for i, s in active:
                if s.mem_gb < task.mem_gb:
                    continue
                if proj[i] > 16.0 * obs.slot_seconds:
                    continue
                sc = score(task, s, (ridx, i), obs.t, obs.slot_seconds,
                           self.loc)
                q_slots = proj[i] / obs.slot_seconds
                sc -= 0.8 * q_slots + 0.4 * q_slots * q_slots
                speed_i = max(s.tflops / 112.0, 0.1)
                sc -= 0.3 * (task.work_s / speed_i) / obs.slot_seconds
                if sc > best_sc:
                    best, best_sc = i, sc
            if best is None:
                out[task.id] = None
                continue
            srv = reg.servers[best]
            speed = max(srv.tflops / 112.0, 0.1)
            proj[best] += task.work_s / speed + srv.switch_cost_s(task.model)
            self.loc.note((ridx, best), task, obs.t)
            out[task.id] = (ridx, best)
        return out


def make_reference_torta(n_regions: int, device="cuda", **kw):
    """A ``TortaScheduler`` on ``device`` whose micro layer is the
    per-object reference."""
    from repro_torch.core.torta import TortaScheduler
    sched = TortaScheduler(n_regions, device=device, **kw)
    sched.micro = ReferenceMicroAllocator(sigma=sched.sigma,
                                          headroom=sched.headroom)
    return sched


class ReferenceRoundRobinScheduler:
    """Pre-refactor RR baseline over the object cluster."""

    name = "RR(ref)"

    def __init__(self, saturation_slots: float = 2.0):
        self.saturation_slots = saturation_slots
        self.reset()

    def reset(self) -> None:
        self._r = 0
        self._ptr: Dict[str, int] = {}
        self.pools: Dict[str, List[Tuple[int, int]]] = {}

    def _grow_pool(self, obs: RefSlotObs, task: Task) -> bool:
        r = obs.cluster.n_regions
        pool = self.pools.setdefault(task.model, [])
        taken = set(pool)
        for _ in range(r):
            ridx = self._r % r
            self._r += 1
            reg = obs.cluster.regions[ridx]
            for sidx, s in enumerate(reg.servers):
                if s.state != "active" or s.mem_gb < task.mem_gb:
                    continue
                if (ridx, sidx) in taken:
                    continue
                pool.append((ridx, sidx))
                return True
        return False

    def schedule(self, obs: RefSlotObs, tasks: List[Task]) -> SlotDecision:
        assignments = {}
        sat = self.saturation_slots * obs.slot_seconds
        proj: Dict[Tuple[int, int], float] = {}
        for task in tasks:
            pool = self.pools.setdefault(task.model, [])
            if not pool:
                self._grow_pool(obs, task)
            placed = False
            for attempt in range(2):
                n = len(pool)
                for k in range(n):
                    p = self._ptr.get(task.model, 0)
                    self._ptr[task.model] = p + 1
                    ridx, sidx = pool[p % n]
                    reg = obs.cluster.regions[ridx]
                    if sidx >= len(reg.servers):
                        continue
                    srv = reg.servers[sidx]
                    if srv.state != "active" or srv.mem_gb < task.mem_gb:
                        continue
                    load = srv.queue_s + proj.get((ridx, sidx), 0.0)
                    if load > sat:
                        continue
                    assignments[task.id] = (ridx, sidx)
                    proj[(ridx, sidx)] = proj.get((ridx, sidx), 0.0) \
                        + task.work_s / max(srv.tflops / 112.0, 0.1)
                    placed = True
                    break
                if placed or not self._grow_pool(obs, task):
                    break
            if not placed:
                assignments[task.id] = None
        return SlotDecision(assignments=assignments)


@dataclasses.dataclass
class _FailureEvent:
    region: int
    start_slot: int
    duration: int


class ReferenceEngine:
    """Pre-refactor engine: per-server Python loops over ``Server`` objects."""

    def __init__(self, topology: Topology, cluster: Cluster,
                 workload: Workload, scheduler, *,
                 slot_seconds: float = 45.0,
                 drop_after_slots: float = 12.0,
                 failures: Optional[list] = None,
                 seed: int = 0):
        # streaming sources are materialized into the legacy object
        # Workload this frozen engine iterates
        self.topo = topology
        self.cluster = cluster
        self.workload = to_legacy_workload(workload)
        self.scheduler = scheduler
        self.slot_s = slot_seconds
        self.drop_after = drop_after_slots
        self.failures = failures or []
        self.rng = np.random.default_rng(seed)
        self.metrics = MetricsAggregator(slot_seconds=slot_seconds)
        r = cluster.n_regions
        self.prev_alloc = np.full((r, r), 1.0 / r)
        self.arrivals_hist: List[np.ndarray] = []
        self.buffers: List[List[Task]] = [[] for _ in range(r)]
        self._failed: Dict[int, int] = {}

    def _obs(self, t: int) -> RefSlotObs:
        c = self.cluster
        r = c.n_regions
        q_s = np.array([sum(s.queue_s for s in reg.active_servers())
                        for reg in c.regions])
        q_n = np.array([len(self.buffers[i]) for i in range(r)]) + \
            q_s / np.maximum(self.slot_s, 1.0)
        hist = (np.stack(self.arrivals_hist) if self.arrivals_hist
                else np.zeros((0, r)))
        return RefSlotObs(
            t=t, latency=self.topo.latency, capacities=c.capacities(),
            total_capacities=np.array([reg.total_capacity
                                       for reg in c.regions]),
            queue_s=q_s, queue_tasks=q_n, utilization=c.utilizations(),
            power_prices=c.power_prices(), prev_alloc=self.prev_alloc,
            arrivals_history=hist, cluster=c, slot_seconds=self.slot_s)

    def _apply_activation(self, targets: Dict[int, int]) -> float:
        overhead = 0.0
        for ridx, n_target in targets.items():
            reg = self.cluster.regions[ridx]
            if ridx in self._failed:
                continue
            n_target = int(np.clip(n_target, 1, len(reg.servers)))
            active = [s for s in reg.servers if s.state == "active"]
            off = [s for s in reg.servers if s.state == "off"]
            warming = [s for s in reg.servers if s.state == "warming"]
            n_now = len(active) + len(warming)
            if n_target > n_now:
                for s in off[:n_target - n_now]:
                    s.state = "warming"
                    s.warm_remaining_s = COLD_START_S
                    overhead += COLD_START_S
            elif n_target < len(active):
                idle_sorted = sorted(active,
                                     key=lambda s: (s.util, -s.idle_slots))
                for s in idle_sorted[:len(active) - n_target]:
                    if s.queue_s <= 0:
                        s.state = "off"
                        s.util = 0.0
        return overhead

    def _step_failures(self, t: int) -> None:
        for ev in self.failures:
            if ev.start_slot == t:
                self._failed[ev.region] = ev.duration
                for s in self.cluster.regions[ev.region].servers:
                    s.state = "off"
                    s.queue_s = 0.0
        done = []
        for ridx in self._failed:
            self._failed[ridx] -= 1
            if self._failed[ridx] <= 0:
                done.append(ridx)
                for s in self.cluster.regions[ridx].servers:
                    s.state = "active"
        for ridx in done:
            del self._failed[ridx]

    def run(self, n_slots: Optional[int] = None) -> MetricsAggregator:
        t_total = n_slots or self.workload.n_slots
        if hasattr(self.scheduler, "reset"):
            self.scheduler.reset()
        for t in range(t_total):
            self._step_failures(t)
            for reg in self.cluster.regions:
                for s in reg.servers:
                    if s.state == "warming":
                        s.warm_remaining_s -= self.slot_s
                        if s.warm_remaining_s <= 0:
                            s.state = "active"
                            s.warm_remaining_s = 0.0

            arrivals = (list(self.workload.tasks[t])
                        if t < len(self.workload.tasks) else [])
            r = self.cluster.n_regions
            arr_vec = np.zeros(r)
            for task in arrivals:
                arr_vec[task.origin] += 1
            self.arrivals_hist.append(arr_vec)
            tasks = [tk for b in self.buffers for tk in b] + arrivals
            for b in self.buffers:
                b.clear()

            obs = self._obs(t)
            decision = self.scheduler.schedule(obs, tasks)
            overhead_s = 0.0
            if decision.activation:
                overhead_s += self._apply_activation(decision.activation)

            alloc = np.zeros((r, r))
            switch_energy_j = 0.0
            n_switches = 0
            for task in tasks:
                tgt = decision.assignments.get(task.id)
                if tgt is None:
                    if t - task.arrival_slot >= self.drop_after:
                        self.metrics.record_drop(task, t)
                    else:
                        self.buffers[task.origin].append(task)
                    continue
                ridx, sidx = tgt
                reg = self.cluster.regions[ridx]
                if ridx in self._failed or not reg.servers:
                    self.buffers[task.origin].append(task)
                    continue
                sidx = int(np.clip(sidx, 0, len(reg.servers) - 1))
                srv = reg.servers[sidx]
                if srv.state != "active":
                    cand = reg.active_servers()
                    if not cand:
                        self.buffers[task.origin].append(task)
                        continue
                    srv = min(cand, key=lambda s: s.queue_s)
                speed = max(srv.tflops / 112.0, 0.1)
                switch_s = srv.switch_cost_s(task.model)
                if switch_s > 0:
                    n_switches += 1
                    switch_energy_j += switch_s * srv.power_w \
                        * SWITCH_POWER_FRAC
                    overhead_s += switch_s
                srv.note_model(task.model)
                work_s = task.work_s / speed
                wait_s = srv.queue_s + switch_s
                net_s = self.topo.latency[task.origin, ridx] / 1000.0
                srv.queue_s += switch_s + work_s
                self.metrics.record_completion(
                    task, t, wait_s=wait_s, work_s=work_s, net_s=net_s)
                alloc[task.origin, ridx] += 1

            row = alloc.sum(1, keepdims=True)
            alloc_n = np.where(row > 0, alloc / np.maximum(row, 1e-9),
                               self.prev_alloc)
            switch_cost_f = float(np.sum((alloc_n - self.prev_alloc) ** 2))
            self.prev_alloc = alloc_n

            utils = []
            for reg in self.cluster.regions:
                for s in reg.servers:
                    if s.state != "active":
                        continue
                    busy = min(s.queue_s, self.slot_s)
                    s.util = busy / self.slot_s
                    s.idle_slots = 0 if s.util > 0.05 else s.idle_slots + 1
                    s.queue_s = max(0.0, s.queue_s - self.slot_s)
                    utils.append(s.util)
            cost = 0.0
            for reg in self.cluster.regions:
                reg_j = sum((0.1 + 0.9 * s.util) * s.power_w * self.slot_s
                            for s in reg.servers if s.state == "active")
                cost += reg_j / 3.6e6 * reg.power_price
            cost += switch_energy_j / 3.6e6 \
                * float(np.mean(self.cluster.power_prices()))

            self.metrics.record_slot(
                t, utils=np.array(utils) if utils else np.zeros(1),
                power_cost=cost, switch_cost=switch_cost_f,
                overhead_s=overhead_s, n_switches=n_switches,
                queue_tasks=float(obs.queue_tasks.sum()))
        return self.metrics
