"""Slotted discrete-event engine (port of ``repro/sim/engine.py``, the
batch-native loop).

The fleet lives in a struct-of-arrays ``ClusterState``, demand arrives as
``TaskBatch`` arrays, and the scheduler answers each slot with a
``BatchDecision`` (``schedule_batch(obs, batch)``); legacy ``schedule()``
schedulers are wrapped in ``api.LegacySchedulerAdapter``, and anything
implementing neither contract raises at construction.  Servers that
receive a single task this slot are applied in one whole-array pass;
same-server
conflicts walk sequentially on the host (a task's wait depends on the
queue its same-server predecessors left behind), and slots in which a
targeted server went inactive replay the per-task resolution loop.

``step_backend="torch"`` (the default) runs warming progression, the
grouped apply, queue drain and power billing through
``sim/engine_torch.py`` on ``device``; ``step_backend="numpy"`` is the
reference's host path, kept as the oracle.  Both give bitwise-equal
metrics.  The host keeps what the reference keeps on the host: the
same-server conflict walk (``engine.fallback.same_server_conflict``) and
the regional power reduction.

Every run leaves ``engine.run_report`` (summary, counters, span table,
per-slot series; ``repro_torch.obs``) unless observability is off
(``obs=False``); the default tier is counters + series, ``obs="trace"``
adds span timing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch import resolve_device
from repro_torch.api import BatchDecision, ensure_batch_scheduler
from repro_torch.obs import Counters, make_obs
from repro_torch.obs import runtime as obs_rt
from repro_torch.sim.cluster import COLD_START_S, SWITCH_POWER_FRAC, Cluster
from repro_torch.sim.metrics import MetricsAggregator
from repro_torch.sim.state import ACTIVE, OFF, WARMING, ClusterState
from repro_torch.sim.topology import Topology
from repro_torch.workload import TaskBatch, as_source


@dataclasses.dataclass
class SlotObs:
    t: int
    latency: np.ndarray              # (R, R) ms
    capacities: np.ndarray           # (R,) active tasks/slot
    total_capacities: np.ndarray     # (R,) incl. inactive
    queue_s: np.ndarray              # (R,) backlog seconds
    queue_tasks: np.ndarray          # (R,) queued task counts (proxy)
    utilization: np.ndarray          # (R,)
    power_prices: np.ndarray         # (R,)
    prev_alloc: np.ndarray           # (R, R)
    arrivals_history: np.ndarray     # (t, R) realized arrivals so far
    state: ClusterState              # full server-level visibility (SoA)
    slot_seconds: float


@dataclasses.dataclass
class FailureEvent:
    region: int
    start_slot: int
    duration: int


_OBS_UNSET = object()      # run(obs=...) default: keep the engine's obs


class Engine:
    def __init__(self, topology: Topology,
                 cluster: Union[Cluster, ClusterState],
                 workload, scheduler, *,
                 slot_seconds: float = 45.0,
                 drop_after_slots: float = 12.0,
                 failures: Optional[List[FailureEvent]] = None,
                 seed: int = 0,       # the reference's; the loop draws nothing
                 batch_mode: Optional[bool] = None,
                 step_backend: str = "torch",
                 device="cuda",
                 obs=None):
        self.device = resolve_device(device)
        self.topo = topology
        self.state = (cluster if isinstance(cluster, ClusterState)
                      else ClusterState.from_cluster(cluster))
        self.source = as_source(workload)
        # one contract: batch-native schedulers pass through, legacy
        # schedule()-style ones are wrapped; batch_mode=False forces the
        # adapter (the switch for A/B-ing the two call shapes)
        self.scheduler = ensure_batch_scheduler(
            scheduler, force_adapter=(batch_mode is False))
        if step_backend not in ("numpy", "torch"):
            raise ValueError(f"unknown step backend: {step_backend!r}")
        self.step_backend = step_backend
        self._stepper = None
        if step_backend == "torch":
            from repro_torch.sim.engine_torch import TorchStepper
            self._stepper = TorchStepper(self.state, self.device)
        self.slot_s = slot_seconds
        self.drop_after = drop_after_slots
        self.failures = failures or []
        self.metrics = MetricsAggregator(slot_seconds=slot_seconds)
        r = self.state.n_regions
        self.prev_alloc = np.full((r, r), 1.0 / r)
        # realized arrivals as a preallocated growing (T, R) buffer
        self._hist = np.zeros((64, r))
        self._hist_n = 0
        self.pending_batch = TaskBatch.empty()   # cross-slot buffer
        self._failed: Dict[int, int] = {}   # region -> slots remaining
        # observability: default-on cheap tier (counters + series); pass
        # obs=False to disable, obs="trace" for opt-in span timing
        self.obs = make_obs(obs)
        self.run_report = None              # RunReport after each run()

    # ------------------------------------------------------------------

    @property
    def counters(self) -> Counters:
        """The run's counters (``self.obs.counters``); an empty
        ``Counters`` when observability or its counters are off."""
        if self.obs is None or self.obs.counters is None:
            return Counters()
        return self.obs.counters

    @property
    def arrivals_hist(self) -> List[np.ndarray]:
        """Realized per-slot arrival vectors (legacy list-of-rows view)."""
        return list(self._hist[:self._hist_n])

    def _record_arrivals(self, counts: np.ndarray) -> None:
        if self._hist_n == self._hist.shape[0]:
            grown = np.zeros((2 * self._hist.shape[0], self._hist.shape[1]))
            grown[:self._hist_n] = self._hist
            self._hist = grown
        self._hist[self._hist_n] = counts
        self._hist_n += 1

    def _obs(self, t: int) -> SlotObs:
        st = self.state
        r = st.n_regions
        q_s = st.queue_by_region()
        q_n = self.pending_batch.origin_counts(r).astype(np.float64) \
            + q_s / np.maximum(self.slot_s, 1.0)
        hist = self._hist[:self._hist_n]
        hist.setflags(write=False)       # rows already written are final
        return SlotObs(
            t=t, latency=self.topo.latency, capacities=st.capacities(),
            total_capacities=st.total_capacities(),
            queue_s=q_s, queue_tasks=q_n, utilization=st.utilizations(),
            power_prices=st.power_prices(), prev_alloc=self.prev_alloc,
            arrivals_history=hist, state=st, slot_seconds=self.slot_s)

    def _apply_activation(self, targets: Dict[int, int]) -> float:
        """Activate/deactivate servers toward targets; returns activation
        overhead seconds (cold starts initiated this slot)."""
        st = self.state
        overhead = 0.0
        for ridx, n_target in targets.items():
            if ridx in self._failed:
                continue
            sl = st.region_slice(ridx)
            n_srv = sl.stop - sl.start
            n_target = int(np.clip(n_target, 1, n_srv))
            codes = st.state[sl]
            active = np.flatnonzero(codes == ACTIVE)
            off = np.flatnonzero(codes == OFF)
            n_now = len(active) + int(np.count_nonzero(codes == WARMING))
            if n_target > n_now:
                # wake idle servers first (shortest cold start)
                wake = off[:n_target - n_now] + sl.start
                st.state[wake] = WARMING
                st.warm_remaining_s[wake] = COLD_START_S
                overhead += COLD_START_S * len(wake)
            elif n_target < len(active):
                # deactivate lowest-utilization, longest-idle servers
                g = active + sl.start
                order = g[np.lexsort((-st.idle_slots[g], st.util[g]))]
                victims = order[:len(active) - n_target]
                victims = victims[st.queue_s[victims] <= 0]
                st.state[victims] = OFF
                st.util[victims] = 0.0
        return overhead

    def _step_failures(self, t: int) -> None:
        st = self.state
        for ev in self.failures:
            if ev.start_slot == t:
                self._failed[ev.region] = ev.duration
                sl = st.region_slice(ev.region)
                st.state[sl] = OFF
                st.queue_s[sl] = 0.0
        done = []
        for ridx in self._failed:
            self._failed[ridx] -= 1
            if self._failed[ridx] <= 0:
                done.append(ridx)
                st.state[st.region_slice(ridx)] = ACTIVE
        for ridx in done:
            del self._failed[ridx]

    def _progress_warming(self) -> None:
        """Warming servers progress toward ACTIVE (whole-array)."""
        if self._stepper is not None:
            self._stepper.progress_warming(self.slot_s)
            return
        st = self.state
        warming = st.state == WARMING
        if warming.any():
            st.warm_remaining_s[warming] -= self.slot_s
            done = warming & (st.warm_remaining_s <= 0)
            st.state[done] = ACTIVE
            st.warm_remaining_s[done] = 0.0

    # ------------------------------------------------------------------

    def _resolve_server(self, ridx: int, sidx: int) -> int:
        """Global index of the assignment target, falling back to the
        least-backlogged active server; -1 when the region can't take the
        task this slot."""
        st = self.state
        sl = st.region_slice(ridx)
        n_srv = sl.stop - sl.start
        if ridx in self._failed or n_srv == 0:
            return -1
        g = sl.start + int(np.clip(sidx, 0, n_srv - 1))
        if st.state[g] != ACTIVE:
            cand = np.flatnonzero(st.state[sl] == ACTIVE)
            if cand.size == 0:
                return -1
            g = sl.start + int(cand[np.argmin(st.queue_s[sl][cand])])
        return g

    def _apply_one(self, g: int, mid: int, work_s_raw: float, origin: int,
                   ridx: int) -> Tuple[float, float, int, float, float,
                                       float]:
        """Place one task on global server ``g``.  Returns (switch energy
        J, switch seconds, 1 if a model switch happened, wait s, work s,
        net s)."""
        st = self.state
        speed = max(float(st.tflops[g]) / 112.0, 0.1)   # V100 ref
        switch_s = st.switch_cost(g, mid)
        switched = 0
        energy_j = 0.0
        if switch_s > 0:
            switched = 1
            energy_j = (switch_s * float(st.power_w[g])
                        * SWITCH_POWER_FRAC)
        st.note_model(g, mid)
        work_s = work_s_raw / speed
        wait_s = float(st.queue_s[g]) + switch_s
        net_s = self.topo.latency[origin, ridx] / 1000.0
        st.queue_s[g] += switch_s + work_s
        return energy_j, switch_s, switched, wait_s, work_s, net_s

    def _apply_decision(self, t: int, batch, decision: BatchDecision):
        """Apply one slot's ``BatchDecision``.  Returns (alloc matrix,
        switch energy J, switch seconds, n model switches, assigned
        mask)."""
        st = self.state
        r = st.n_regions
        n = len(batch)
        alloc = np.zeros((r, r))
        assigned = np.zeros(n, bool)
        if n == 0:
            return alloc, 0.0, 0.0, 0, assigned
        region = decision.region
        cand = region >= 0
        if not cand.any():
            return alloc, 0.0, 0.0, 0, assigned

        failed = np.zeros(r, bool)
        for ridx in self._failed:
            failed[ridx] = True
        reg = np.where(cand, region, 0)
        n_srv = st.region_sizes()[reg]
        ok_region = cand & ~failed[reg] & (n_srv > 0)
        g0 = np.where(ok_region,
                      st.region_ptr[:-1][reg] + decision.server, 0)
        direct = ok_region & (st.state[g0] == ACTIVE)
        if np.array_equal(direct, ok_region):
            # every resolvable target is directly active: grouped apply
            n_rf = int(np.count_nonzero(cand & ~ok_region))
            if n_rf:
                obs_rt.count("engine.tasks.resolve_failed", n_rf)
            return self._apply_grouped(t, batch, region, g0, direct,
                                       alloc, assigned)
        # some targeted server went inactive between decision and apply:
        # replay the per-task loop so the least-backlogged fallback sees
        # queues exactly as they evolve
        obs_rt.count("engine.fallback.inactive_target_slot")
        return self._apply_sequential(t, batch, decision, alloc, assigned)

    def _apply_grouped(self, t: int, batch, region: np.ndarray,
                       g0: np.ndarray, rows_mask: np.ndarray,
                       alloc: np.ndarray, assigned: np.ndarray):
        """Unique-server whole-array apply; sequential only within
        same-server conflicts."""
        st = self.state
        rows = np.flatnonzero(rows_mask)
        g = g0[rows]
        _, inverse, counts = np.unique(g, return_inverse=True,
                                       return_counts=True)
        multi = (counts > 1)[inverse]
        pos_single = np.flatnonzero(~multi)
        pos_multi = np.flatnonzero(multi)
        wait = np.empty(rows.size)
        work = np.empty(rows.size)
        net = np.empty(rows.size)
        energy_total = 0.0
        switch_total = 0.0
        n_switches = 0
        if pos_multi.size:
            obs_rt.count("engine.fallback.same_server_conflict",
                         pos_multi.size)

        if pos_single.size:
            single_rows = rows[pos_single]
            gs = g[pos_single]
            mids = batch.model_idx[single_rows].astype(np.int64)
            if self._stepper is not None:
                sw, energy, wt, wk = self._stepper.apply_single_rows(
                    gs, mids, batch.work_s[single_rows])
                wait[pos_single] = wt
            else:
                speed = np.maximum(st.tflops[gs] / 112.0, 0.1)
                sw = st.switch_cost_rows(gs, mids)
                energy = np.where(sw > 0,
                                  sw * st.power_w[gs] * SWITCH_POWER_FRAC,
                                  0.0)
                st.note_model_rows(gs, mids)
                wk = batch.work_s[single_rows] / speed
                wait[pos_single] = st.queue_s[gs] + sw
                st.queue_s[gs] += sw + wk
            work[pos_single] = wk
            net[pos_single] = self.topo.latency[
                batch.origin[single_rows], region[single_rows]] / 1000.0
            energy_total += float(energy.sum())
            switch_total += float(sw.sum())
            n_switches += int(np.count_nonzero(sw > 0))

        for p in pos_multi:
            i = int(rows[p])
            e, s_s, sw_flag, wt, wk, nt = self._apply_one(
                int(g0[i]), int(batch.model_idx[i]),
                float(batch.work_s[i]), int(batch.origin[i]),
                int(region[i]))
            energy_total += e
            switch_total += s_s
            n_switches += sw_flag
            wait[p], work[p], net[p] = wt, wk, nt

        self.metrics.record_completions(t, wait, work, net)
        np.add.at(alloc, (batch.origin[rows], region[rows]), 1.0)
        assigned[rows] = True
        return alloc, energy_total, switch_total, n_switches, assigned

    def _apply_sequential(self, t: int, batch, decision: BatchDecision,
                          alloc: np.ndarray, assigned: np.ndarray):
        """Per-task resolution + application in row order."""
        energy_total = 0.0
        switch_total = 0.0
        n_switches = 0
        n_resolve_failed = 0
        waits: List[float] = []
        works: List[float] = []
        nets: List[float] = []
        for i in range(len(batch)):
            ridx = int(decision.region[i])
            if ridx < 0:
                continue
            g = self._resolve_server(ridx, int(decision.server[i]))
            if g < 0:
                n_resolve_failed += 1
                continue
            e, s_s, sw_flag, wt, wk, nt = self._apply_one(
                g, int(batch.model_idx[i]), float(batch.work_s[i]),
                int(batch.origin[i]), ridx)
            energy_total += e
            switch_total += s_s
            n_switches += sw_flag
            waits.append(wt)
            works.append(wk)
            nets.append(nt)
            alloc[batch.origin[i], ridx] += 1
            assigned[i] = True
        if n_resolve_failed:
            obs_rt.count("engine.tasks.resolve_failed", n_resolve_failed)
        self.metrics.record_completions(t, waits, works, nets)
        return alloc, energy_total, switch_total, n_switches, assigned

    # ------------------------------------------------------------------

    def _finish_slot(self, t: int, obs: SlotObs, alloc: np.ndarray,
                     switch_energy_j: float, n_switches: int,
                     overhead_s: float) -> None:
        """Allocation smoothing cost, queue drain, power billing and the
        per-slot metrics record."""
        st = self.state
        r = st.n_regions
        row = alloc.sum(1, keepdims=True)
        alloc_n = np.where(row > 0, alloc / np.maximum(row, 1e-9),
                           self.prev_alloc)
        switch_cost_f = float(np.sum((alloc_n - self.prev_alloc) ** 2))
        self.prev_alloc = alloc_n

        if self._stepper is not None:
            power_server, act = self._stepper.close_slot(self.slot_s)
        else:
            act = st.active_mask()
            busy = np.minimum(st.queue_s, self.slot_s)
            new_util = busy / self.slot_s
            st.util = np.where(act, new_util, st.util)
            st.idle_slots = np.where(
                act, np.where(st.util > 0.05, 0, st.idle_slots + 1),
                st.idle_slots)
            st.queue_s = np.where(
                act, np.maximum(0.0, st.queue_s - self.slot_s), st.queue_s)
            power_server = np.where(
                act, (0.1 + 0.9 * st.util) * st.power_w * self.slot_s, 0.0)
        utils = st.util[act]
        # bill at regional prices (host reduction: parity op order)
        reg_j = st._segsum(power_server)
        cost = 0.0
        for j in range(r):                 # sequential (parity) — R small
            cost += reg_j[j] / 3.6e6 * st.power_price[j]
        cost += switch_energy_j / 3.6e6 * float(np.mean(st.power_price))

        self.metrics.record_slot(
            t, utils=utils if utils.size else np.zeros(1),
            power_cost=cost, switch_cost=switch_cost_f,
            overhead_s=overhead_s, n_switches=n_switches,
            queue_tasks=float(obs.queue_tasks.sum()))

    # ------------------------------------------------------------------

    def run(self, n_slots: Optional[int] = None, *,
            obs=_OBS_UNSET) -> MetricsAggregator:
        """The engine loop: ``TaskBatch`` in, ``BatchDecision`` out,
        grouped whole-array apply.

        ``obs`` overrides the engine's observability for this and later
        runs (same spec surface as the constructor: ``False`` off,
        ``"trace"`` adds span timing).  After the run,
        ``self.run_report`` holds the :class:`repro_torch.obs.RunReport`
        (None when observability is off); the return value stays the
        plain ``MetricsAggregator``."""
        if obs is not _OBS_UNSET:
            self.obs = make_obs(obs)
        t_total = n_slots or self.source.n_slots
        self.scheduler.reset()
        if self.obs is not None:
            self.obs.begin_run(self.state.n_regions, self.slot_s)
        with obs_rt.activate(self.obs):
            self._run_loop(t_total)
        if self.obs is not None:
            self.run_report = self.obs.report(
                summary=self.metrics.summary(),
                meta={"n_slots": t_total,
                      "n_regions": self.state.n_regions,
                      "n_servers": self.state.n_servers,
                      "scheduler": getattr(self.scheduler, "name", "?"),
                      "step_backend": self.step_backend,
                      "slot_seconds": self.slot_s})
        return self.metrics

    def _run_loop(self, t_total: int) -> None:
        st = self.state
        r = st.n_regions
        src = self.source
        track = self.obs is not None and self.obs.series is not None
        for t in range(t_total):
            self._step_failures(t)
            self._progress_warming()

            new = (src.slot_batch(t) if t < src.n_slots
                   else TaskBatch.empty())
            self._record_arrivals(
                new.origin_counts(r).astype(np.float64))
            if len(new):
                obs_rt.count("engine.tasks.arrived", len(new))
            # buffered tasks get first chance
            batch = TaskBatch.concat(self.pending_batch, new)
            self.pending_batch = TaskBatch.empty()

            obs = self._obs(t)
            n_resp0 = len(self.metrics.response_times)
            with obs_rt.span("schedule.batch"):
                decision = self.scheduler.schedule_batch(obs, batch)
            decision.validate(len(batch), st)
            overhead_s = 0.0
            targets = decision.activation_targets(r)
            if targets:
                overhead_s += self._apply_activation(targets)

            with obs_rt.span("engine.apply"):
                (alloc, switch_energy_j, switch_s, n_switches,
                 assigned) = self._apply_decision(t, batch, decision)
            overhead_s += switch_s

            # every unassigned row ages out the same way, whether the
            # scheduler buffered it or its server failed resolution
            n_drop = 0
            left = np.flatnonzero(~assigned)
            if left.size:
                too_old = (t - batch.arrival_slot[left]) >= self.drop_after
                n_drop = int(np.count_nonzero(too_old))
                if n_drop:
                    self.metrics.record_drops(n_drop, t)
                    obs_rt.count("engine.tasks.dropped", n_drop)
                keep = left[~too_old]
                if keep.size:
                    obs_rt.count("engine.tasks.buffered", keep.size)
                # reference-faithful buffer order: group rows by origin
                keep = keep[np.argsort(batch.origin[keep], kind="stable")]
                self.pending_batch = batch.select(keep)
            n_assigned = int(np.count_nonzero(assigned))
            if n_assigned:
                obs_rt.count("engine.tasks.assigned", n_assigned)

            with obs_rt.span("engine.slot_close"):
                self._finish_slot(t, obs, alloc, switch_energy_j,
                                  n_switches, overhead_s)
            if track:
                self._observe_slot(t, obs, n_resp0, n_drop)

    def _observe_slot(self, t: int, obs: SlotObs, n_resp0: int,
                      n_drop: int) -> None:
        """Feed the per-slot series recorder.  Observation-only: reads
        values the slot already produced (responses appended this slot,
        the lb record, arrivals row, the fleet's host mirror) — never
        engine state it could change, so summary metrics stay bitwise
        equal to an obs-off run."""
        st = self.state
        m = self.metrics
        responses = np.asarray(m.response_times[n_resp0:], np.float64)
        act = (st.state == ACTIVE).astype(np.float64)
        cum = np.concatenate(([0.0], np.cumsum(act)))
        act_counts = cum[st.region_ptr[1:]] - cum[st.region_ptr[:-1]]
        saturation = act_counts / np.maximum(st.region_sizes(), 1)
        self.obs.end_slot(
            t, responses=responses,
            queue_tasks=float(obs.queue_tasks.sum()),
            arrivals=self._hist[self._hist_n - 1],
            drops=n_drop, saturation=saturation,
            load_balance=m.lb_by_slot[-1] if m.lb_by_slot else 1.0)
