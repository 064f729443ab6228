"""The object path of the port against the JAX package: the object
cluster's methods and its round trip through ``ClusterState``, the
scalar Eq 7-10 functions and ``LocalityTracker``, the tracker adapters of
``LocalityState``, ``MicroAllocator.assign_region`` and
``locality_tracker``, TORTA's legacy ``schedule()`` with the sticky
distribution, the adapter's ``obs_mode="cluster"``, and the frozen
per-object oracle (``sim/reference.py``) with the golden parity it pins.

The reference's TORTA is built with ``use_sinkhorn_kernel=True`` wherever
it is compared with the port (its float32 plan is the one the port
computes); decisions must be identical and summaries equal (rtol 0).
"""
import copy
import dataclasses

import numpy as np
import pytest

from _torch_port import port_state, world
from repro.core import micro as ref_micro
from repro.core.micro_state import LocalityState as RefLocalityState
from repro.core.torta import TortaScheduler as RefTorta
from repro.sim import Engine as RefEngine
from repro.sim import make_cluster as ref_make_cluster
from repro.sim import make_cluster_state, make_topology, make_workload
from repro.sim import reference as ref_reference
from repro.sim.cluster import throughput_per_slot
from repro_torch.api import (LegacySchedulerAdapter, ensure_batch_scheduler)
from repro_torch.core import micro
from repro_torch.core.micro import LocalityTracker, MicroAllocator
from repro_torch.core.micro_state import LocalityState
from repro_torch.core.torta import TortaScheduler
from repro_torch.sim import make_topology as p_make_topology
from repro_torch.sim import reference
from repro_torch.sim.cluster import make_cluster
from repro_torch.sim.engine import Engine
from repro_torch.sim.state import (MODEL_NAMES, ClusterState, model_id)
from repro_torch.sim.state import make_cluster_state as p_make_cluster_state
from repro_torch.sim.topology import Topology
from repro_torch.workload import Task, TaskBatch
from repro_torch.workload import make_workload as p_make_workload

PARITY_KEYS = ("completed", "dropped", "model_switches",
               "power_cost_total", "switch_cost_total",
               "mean_response_s", "mean_wait_s", "operational_overhead")
ROUTES = {"numpy": dict(micro_backend="numpy"),
          "fused": dict(micro_backend="fused"),
          "jax": dict(micro_backend="jax"),
          "jax+fused": dict(micro_backend="jax", micro_fused_kernel=True),
          "pallas": dict(use_compat_kernel=True)}
STICKY_SLOTS = 8
ORACLE_SLOTS = 6
OUTAGE = (1, 3, 2)               # region 1 down for slots 3-4


# ------------------------------------------------------------------ worlds


def _busy_state(r: int, spr: int, seed: int):
    """``_torch_port.world``'s randomized fleet (states, queues,
    utilizations) with model caches that ``note_model`` could have left:
    30 notes on random servers, from empty caches (the reference's state;
    ``port_state`` of it is the port's)."""
    cs, rng = world(r, spr, seed)
    cs.current_model[:] = -1
    cs.warm_models[:] = -1
    cs.warm_remaining_s[:] = rng.uniform(0.0, 90.0, cs.n_servers)
    cs.idle_slots[:] = rng.integers(0, 5, cs.n_servers)
    for _ in range(30):
        cs.note_model(int(rng.integers(cs.n_servers)),
                      int(rng.integers(len(MODEL_NAMES))))
    return cs


def _busy_clusters(seed: int = 7):
    """The same busy fleet as the reference's object cluster and the
    port's."""
    cs = _busy_state(4, 6, seed)
    return cs.to_cluster(), port_state(cs).to_cluster()


def _parity_world(slots: int):
    """``tests/test_engine_parity.py``'s world built by each package:
    abilene, ``make_cluster(seed=3)``, demand at 0.3 of throughput."""
    topo, p_topo = make_topology("abilene", seed=1), \
        p_make_topology("abilene", seed=1)
    r = topo.n_regions
    cluster = ref_make_cluster(r, seed=3)
    rate = 0.3 * throughput_per_slot(cluster) / r
    return (topo, cluster, make_workload(slots, r, seed=2, base_rate=rate),
            p_topo, make_cluster(r, seed=3),
            p_make_workload(slots, r, seed=2, base_rate=rate))


def _sticky_world():
    """``run_matrix``'s abilene cell (demand at 0.35) for each package."""
    topo, p_topo = make_topology("abilene", seed=1), \
        p_make_topology("abilene", seed=1)
    r = topo.n_regions
    cs = make_cluster_state(r, seed=3)
    rate = 0.35 * throughput_per_slot(cs) / r
    return (topo, cs, make_workload(STICKY_SLOTS, r, seed=2, base_rate=rate),
            p_topo, p_make_cluster_state(r, seed=3),
            p_make_workload(STICKY_SLOTS, r, seed=2, base_rate=rate))


def _tasks(n: int, seed: int = 5):
    """(reference tasks, port tasks) of the same seeded workload slot."""
    ref = make_workload(1, 2, seed=seed, base_rate=float(n)).tasks[0][:n]
    port = p_make_workload(1, 2, seed=seed, base_rate=float(n)).tasks[0][:n]
    return ref, port


class SlotRecorder:
    """Wraps a legacy scheduler and keeps every ``SlotDecision``."""

    def __init__(self, inner):
        self.inner = inner
        self.name = inner.name
        self.decisions = []

    def reset(self):
        self.inner.reset()
        self.decisions = []

    def schedule(self, obs, tasks):
        d = self.inner.schedule(obs, tasks)
        self.decisions.append((dict(d.assignments),
                               dict(d.activation or {})))
        return d


class BatchRecorder:
    """Wraps a batch scheduler and keeps (region, server) of every slot."""

    def __init__(self, inner):
        self.inner = inner
        self.name = inner.name
        self.decisions = []

    def reset(self):
        self.inner.reset()
        self.decisions = []

    def schedule_batch(self, obs, batch):
        d = self.inner.schedule_batch(obs, batch)
        self.decisions.append((np.array(d.region), np.array(d.server)))
        return d


def _same_decisions(got, want):
    assert len(got) == len(want)
    for t, (g, w) in enumerate(zip(got, want)):
        for a, b in zip(g, w):
            if isinstance(b, dict):
                assert a == b, f"slot {t}"
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"slot {t}")


def _same_summary(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == v or (np.isnan(got[k]) and np.isnan(v)), k


# ---------------------------------------------------------- object cluster


def test_object_methods_match_reference():
    want, got = _busy_clusters()
    assert got.n_regions == want.n_regions
    np.testing.assert_array_equal(got.capacities(), want.capacities())
    np.testing.assert_array_equal(got.power_prices(), want.power_prices())
    np.testing.assert_array_equal(got.utilizations(), want.utilizations())
    for rg, rw in zip(got.regions, want.regions):
        assert (rg.capacity, rg.total_capacity) == \
            (rw.capacity, rw.total_capacity)
        assert [s.gpu for s in rg.active_servers()] == \
            [s.gpu for s in rw.active_servers()]
        for sg, sw in zip(rg.servers, rw.servers):
            assert (sg.tflops, sg.mem_gb, sg.power_w, sg.kind) == \
                (sw.tflops, sw.mem_gb, sw.power_w, sw.kind)
            for model in MODEL_NAMES:
                assert sg.switch_cost_s(model) == sw.switch_cost_s(model)
    # note_model's MRU update on both sides
    sg, sw = got.regions[0].servers[0], want.regions[0].servers[0]
    for model in ("llama3-8b", "tinyllama-1.1b", "qwen2.5-3b",
                  "mixtral-8x7b", "llama3-8b", "whisper-small"):
        sg.note_model(model)
        sw.note_model(model)
        assert (sg.current_model, sg.warm_models) == \
            (sw.current_model, sw.warm_models)


def test_cluster_round_trip_matches_reference():
    """``to_cluster`` field by field against ``repro.sim``'s, and
    ``from_cluster(to_cluster())`` back to every array bitwise."""
    cs = _busy_state(5, 7, 3)
    st = port_state(cs)
    got, want = st.to_cluster(), cs.to_cluster()
    for rg, rw in zip(got.regions, want.regions, strict=True):
        assert (rg.idx, rg.power_price) == (rw.idx, rw.power_price)
        for sg, sw in zip(rg.servers, rw.servers, strict=True):
            assert dataclasses.asdict(sg) == dataclasses.asdict(sw)
    back = ClusterState.from_cluster(got)
    for f in dataclasses.fields(ClusterState):
        np.testing.assert_array_equal(getattr(back, f.name),
                                      getattr(st, f.name), err_msg=f.name)
        assert getattr(back, f.name).dtype == getattr(st, f.name).dtype
    want_back = type(cs).from_cluster(want)
    for f in dataclasses.fields(ClusterState):
        np.testing.assert_array_equal(getattr(back, f.name),
                                      getattr(want_back, f.name),
                                      err_msg=f.name)


def test_switch_cost_s_matches_state():
    st = p_make_cluster_state(3, seed=11)
    srv = st.to_cluster().regions[0].servers[0]
    for model in ("llama3-8b", "tinyllama-1.1b", "llama3-8b",
                  "qwen2.5-3b", "mixtral-8x7b", "llama3-8b"):
        assert st.switch_cost(0, model_id(model)) == srv.switch_cost_s(model)
        st.note_model(0, model_id(model))
        srv.note_model(model)
        assert st.to_cluster().regions[0].servers[0].warm_models == \
            srv.warm_models
    assert st.current_model[0] == model_id("llama3-8b")


# ------------------------------------------------------ scalar Eq 7-10


def test_scalar_score_matches_reference():
    """``hw_compatibility``, ``load_compatibility``,
    ``LocalityTracker.locality`` and ``score`` bitwise against the
    reference's on a busy fleet with warm models and history."""
    want_c, got_c = _busy_clusters(seed=9)
    ref_tasks, tasks = _tasks(12)
    ref_loc, loc = ref_micro.LocalityTracker(), LocalityTracker()
    for k, (rt, pt) in enumerate(zip(ref_tasks[:6], tasks[:6])):
        ref_loc.note((0, k % 3), rt, k % 2)
        loc.note((0, k % 3), pt, k % 2)
    ref_loc.note_fields((0, 1), -1, None, 1)
    loc.note_fields((0, 1), -1, None, 1)
    for rt, pt in zip(ref_tasks, tasks):
        for j, (sw, sg) in enumerate(zip(want_c.regions[0].servers,
                                         got_c.regions[0].servers)):
            assert micro.hw_compatibility(pt, sg) == \
                ref_micro.hw_compatibility(rt, sw)
            assert micro.load_compatibility(sg, 45.0) == \
                ref_micro.load_compatibility(sw, 45.0)
            assert loc.locality((0, j), pt, 2) == \
                ref_loc.locality((0, j), rt, 2)
            assert micro.score(pt, sg, (0, j), 2, 45.0, loc) == \
                ref_micro.score(rt, sw, (0, j), 2, 45.0, ref_loc)


def test_task_feature_matrix_matches_reference():
    ref_tasks, tasks = _tasks(20, seed=8)
    got = micro.task_feature_matrix(tasks)
    np.testing.assert_array_equal(got,
                                  ref_micro.task_feature_matrix(ref_tasks))
    np.testing.assert_array_equal(got, micro.task_feature_arrays(
        np.array([micro._KIND_IDX[t.kind] for t in tasks]),
        np.array([t.mem_gb for t in tasks])))


def test_batched_score_matches_scalar():
    """The batched (N x S) matrix equals the scalar Eq 7-10 score (a fresh
    fleet has no warm models, so the warm bonus is 0)."""
    st = p_make_cluster_state(2, seed=5)
    cluster = st.to_cluster()
    tasks = p_make_workload(2, 2, seed=6, base_rate=8.0).tasks[0][:12]
    sl = st.region_slice(0)
    loc = LocalityTracker()
    loc.note((0, 1), tasks[0], 0)
    loc.note((0, 1), tasks[-1], 0)
    embeds = np.stack([t.embed for t in tasks])
    norms = np.linalg.norm(embeds, axis=1)
    has = np.ones(len(tasks), bool)
    mids = np.array([model_id(t.model) for t in tasks], np.int16)
    loc_mat = np.stack([loc.locality_column((0, i), mids, embeds, norms,
                                            has, t=1)
                        for i in range(sl.stop - sl.start)], axis=1)
    got = micro.batched_score_matrix(
        micro.task_feature_matrix(tasks),
        micro.server_feature_matrix(st, sl, 45.0), loc_mat,
        backend="numpy", device="cpu")
    for i, task in enumerate(tasks):
        for j, srv in enumerate(cluster.regions[0].servers):
            want = micro.score(task, srv, (0, j), 1, 45.0, loc)
            assert got[i, j] == pytest.approx(want, abs=1e-6), (i, j)


# ------------------------------------------------------- tracker adapters


def _seed_tracker(tracker, rng, n_servers=5, edim=8, notes=30):
    for _ in range(notes):
        srv = int(rng.integers(0, n_servers))
        mid = int(rng.integers(-1, len(MODEL_NAMES)))
        embed = (rng.standard_normal(edim).astype(np.float32)
                 if rng.random() > 0.3 else None)
        tracker.note_fields((0, srv), mid, embed, int(rng.integers(0, 6)))
    return tracker


def _random_columns(rng, n=17, edim=8):
    embeds = rng.standard_normal((n, edim)).astype(np.float32)
    has = rng.random(n) > 0.3
    embeds[~has] = 0.0
    return (rng.integers(0, len(MODEL_NAMES), n).astype(np.int16), embeds,
            np.linalg.norm(embeds, axis=1), has)


def test_tracker_round_trip_matches_reference():
    """``from_tracker`` equals the reference's arrays; every column of the
    rings and of ``to_tracker``'s tracker equals the tracker's, bitwise."""
    tracker = _seed_tracker(LocalityTracker(), np.random.default_rng(11))
    ref_tracker = _seed_tracker(ref_micro.LocalityTracker(),
                                np.random.default_rng(11))
    lstate = LocalityState.from_tracker(tracker, 0, 5)
    want = RefLocalityState.from_tracker(ref_tracker, 0, 5)
    for f in dataclasses.fields(LocalityState):
        np.testing.assert_array_equal(getattr(lstate, f.name),
                                      getattr(want, f.name), err_msg=f.name)
    cols = _random_columns(np.random.default_rng(2))
    back = lstate.to_tracker(0)
    for s in range(5):
        col = tracker.locality_column((0, s), *cols, 7)
        np.testing.assert_array_equal(lstate.column(s, *cols, 7), col)
        np.testing.assert_array_equal(
            back.locality_column((0, s), *cols, 7), col)
        np.testing.assert_array_equal(
            ref_tracker.locality_column((0, s), *cols, 7), col)


def _tracker_entries(tracker):
    return {key: [(rt.mid, rt.slot, rt.norm,
                   None if rt.embed is None else rt.embed.tolist())
                  for rt in lst]
            for key, lst in tracker.recent.items()}


def test_locality_tracker_fused_equals_numpy():
    """After four slots, the fused route's device rings read back as the
    same tracker as the numpy route's host rings and the reference's."""
    topo, cs, wl, p_topo, p_cs, p_wl = _sticky_world()
    r = topo.n_regions
    trackers = {}
    for name in ("numpy", "fused"):
        sched = TortaScheduler(r, seed=0, device="cpu", **ROUTES[name])
        Engine(p_topo, p_cs.copy(), p_wl, sched, seed=4,
               device="cpu").run(4)
        trackers[name] = sched.micro.locality_tracker()
    ref = RefTorta(r, seed=0, use_sinkhorn_kernel=True)
    RefEngine(topo, cs.copy(), wl, ref, seed=4, step_backend="numpy").run(4)
    want = _tracker_entries(ref.micro.locality_tracker())
    assert want
    assert _tracker_entries(trackers["numpy"]) == want
    assert _tracker_entries(trackers["fused"]) == want


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_assign_region_respects_memory(route):
    """A 60 GB task lands only on a server with the memory for it, and
    ``assign_region`` places a mixed group as ``assign_batch`` does."""
    st = p_make_cluster_state(3, seed=0)
    src = p_make_workload(2, 3, seed=1, base_rate=6.0)
    eng = Engine(_synth_topo(3), st, src, TortaScheduler(3, device="cpu"),
                 device="cpu", step_backend="numpy")
    obs = eng._obs(0)
    alloc = MicroAllocator(backend=ROUTES[route].get("micro_backend",
                                                     "pallas"),
                           fused=ROUTES[route].get("micro_fused_kernel",
                                                   False), device="cpu")
    big = Task(id=1, origin=0, model="mixtral-8x7b", kind="memory",
               work_s=30.0, mem_gb=60.0, deadline_slot=5, arrival_slot=0)
    out = alloc.assign_region(obs, 0, [big])
    assert set(out) == {1}
    if out[1] is not None:
        ridx, sidx = out[1]
        assert ridx == 0
        assert st.mem_gb[st.region_ptr[0] + sidx] >= big.mem_gb
    tasks = src.tasks[0]
    got = MicroAllocator(backend=alloc.backend, fused=alloc.fused,
                         device="cpu").assign_region(obs, 1, tasks)
    batch = TaskBatch.from_tasks(tasks)
    servers = MicroAllocator(backend=alloc.backend, fused=alloc.fused,
                             device="cpu").assign_batch(
        obs, 1, batch, np.arange(len(tasks)))
    assert got == {t.id: ((1, int(s)) if s >= 0 else None)
                   for t, s in zip(tasks, servers)}
    assert any(v is not None for v in got.values())


def _synth_topo(r):
    lat = np.full((r, r), 20.0)
    np.fill_diagonal(lat, 0.0)
    return Topology(f"t{r}", r, 10, lat)


# ------------------------------------------------ the frozen oracle itself


ORACLE_CASES = ("rr", "rr+outage", "torta", "torta+outage")


@pytest.mark.parametrize("case", ORACLE_CASES)
def test_reference_engine_matches_reference(case):
    """The port's ``ReferenceEngine`` against ``repro.sim.reference``'s,
    with the frozen RR or TORTA, with and without a regional outage:
    identical decisions each slot, equal per-slot metrics and summary."""
    topo, cluster, wl, p_topo, p_cluster, p_wl = _parity_world(ORACLE_SLOTS)
    r = topo.n_regions
    if case.startswith("rr"):
        want_s = ref_reference.ReferenceRoundRobinScheduler()
        got_s = reference.ReferenceRoundRobinScheduler()
    else:
        want_s = ref_reference.make_reference_torta(
            r, seed=0, use_sinkhorn_kernel=True)
        got_s = reference.make_reference_torta(r, device="cpu", seed=0)
    outage = case.endswith("outage")
    want = SlotRecorder(want_s)
    got = SlotRecorder(got_s)
    m_want = ref_reference.ReferenceEngine(
        topo, cluster, wl, want, seed=0,
        failures=[ref_reference._FailureEvent(*OUTAGE)] if outage else None
    ).run()
    m_got = reference.ReferenceEngine(
        p_topo, p_cluster, p_wl, got, seed=0,
        failures=[reference._FailureEvent(*OUTAGE)] if outage else None
    ).run()
    _same_decisions(got.decisions, want.decisions)
    for name in ("power_cost_by_slot", "switch_cost_by_slot",
                 "overhead_by_slot", "switch_count_by_slot",
                 "queue_by_slot", "lb_by_slot", "response_times",
                 "completion_slots"):
        assert getattr(m_got, name) == getattr(m_want, name), name
    assert m_got.drops_by_slot == m_want.drops_by_slot
    _same_summary(m_got.summary(), m_want.summary())
    assert m_got.completed > 0


@pytest.mark.parametrize("which", ["rr", "torta", "torta-numpy"])
def test_golden_parity(which):
    """The port's array engine (torch step) against the port's frozen
    oracle on ``tests/test_engine_parity.py``'s world: ``PARITY_KEYS``
    within rel 1e-6.  "rr" drives the frozen RR through
    ``LegacySchedulerAdapter(obs_mode="cluster")``; "torta" pins the
    fused route, "torta-numpy" the host walk, to the per-object TORTA."""
    _, _, _, topo, cluster, wl = _parity_world(20)
    if which == "rr":
        ref_sched = reference.ReferenceRoundRobinScheduler()
        new_sched = LegacySchedulerAdapter(
            reference.ReferenceRoundRobinScheduler(), obs_mode="cluster")
    else:
        ref_sched = reference.make_reference_torta(topo.n_regions,
                                                   device="cpu", seed=0)
        new_sched = TortaScheduler(
            topo.n_regions, seed=0, device="cpu",
            micro_backend="fused" if which == "torta" else "numpy")
    s_ref = reference.ReferenceEngine(topo, copy.deepcopy(cluster), wl,
                                      ref_sched, seed=0).run().summary()
    s_new = Engine(topo, copy.deepcopy(cluster), wl, new_sched, seed=0,
                   device="cpu").run().summary()
    assert s_ref["completed"] > 0
    for k in PARITY_KEYS:
        assert s_new[k] == pytest.approx(s_ref[k], rel=1e-6), k


def test_adapter_cluster_view():
    """``obs_mode="cluster"`` hands the wrapped scheduler a ``RefSlotObs``
    whose cluster converts back to the engine's state of that slot,
    bitwise; the engine schedules through it."""
    seen = []

    class Spy(LegacySchedulerAdapter):
        def _convert_obs(self, obs):
            view = super()._convert_obs(obs)
            seen.append((obs, obs.state.copy(), view))
            return view

    _, _, _, topo, cluster, wl = _parity_world(3)
    eng = Engine(topo, copy.deepcopy(cluster), wl,
                 Spy(reference.ReferenceRoundRobinScheduler(),
                     obs_mode="cluster"), seed=0, device="cpu")
    assert eng.run().summary()["completed"] > 0
    assert len(seen) == 3
    for obs, state, view in seen:
        assert isinstance(view, reference.RefSlotObs)
        back = ClusterState.from_cluster(view.cluster)
        for f in dataclasses.fields(ClusterState):
            np.testing.assert_array_equal(getattr(back, f.name),
                                          getattr(state, f.name),
                                          err_msg=f.name)
        for f in dataclasses.fields(reference.RefSlotObs):
            if f.name != "cluster":
                assert getattr(view, f.name) is getattr(obs, f.name), f.name


# ------------------------------------------------------ sticky and legacy


def _sticky_run(sched, p_topo, p_cs, p_wl, **kw):
    rec = BatchRecorder(ensure_batch_scheduler(sched))
    s = Engine(p_topo, p_cs.copy(), p_wl, rec, seed=4, device="cpu",
               **kw).run(STICKY_SLOTS).summary()
    return rec.decisions, s


def test_sticky_matches_reference():
    """Sticky TORTA (numpy micro route) against the reference's sticky
    TORTA on abilene for 8 slots: identical decisions, equal summary."""
    topo, cs, wl, p_topo, p_cs, p_wl = _sticky_world()
    r = topo.n_regions
    from repro.api import ensure_batch_scheduler as ref_ensure
    rec = BatchRecorder(ref_ensure(RefTorta(r, seed=0, distribution="sticky",
                                            use_sinkhorn_kernel=True)))
    want_s = RefEngine(topo, cs.copy(), wl, rec, seed=4,
                       step_backend="numpy").run(STICKY_SLOTS).summary()
    sched = TortaScheduler(r, seed=0, device="cpu", distribution="sticky",
                           micro_backend="numpy")
    got, got_s = _sticky_run(sched, p_topo, p_cs, p_wl)
    assert len(got) == STICKY_SLOTS
    _same_decisions(got, rec.decisions)
    _same_summary(got_s, want_s)
    assert sched._sticky and got_s["completed"] > 0


@pytest.mark.parametrize("route", ["fused", "jax", "jax+fused", "pallas"])
def test_sticky_route_equals_numpy(route):
    """The port's sticky TORTA on each kernel route equals its numpy
    route (the reference's fused route needs jax.experimental.enable_x64,
    which jax 0.9 dropped, so the routes are held to the port's own)."""
    topo, cs, wl, p_topo, p_cs, p_wl = _sticky_world()
    r = topo.n_regions
    runs = [_sticky_run(TortaScheduler(r, seed=0, device="cpu",
                                       distribution="sticky",
                                       **ROUTES[name]), p_topo, p_cs, p_wl)
            for name in ("numpy", route)]
    _same_decisions(runs[1][0], runs[0][0])
    _same_summary(runs[1][1], runs[0][1])


def test_batch_mode_false_equals_native():
    """``batch_mode=False`` routes TORTA (sample) through its legacy
    ``schedule()``; it must land on the native trajectory exactly."""
    *_, p_topo, p_cs, p_wl = _sticky_world()
    r = p_topo.n_regions
    native = Engine(p_topo, p_cs.copy(), p_wl,
                    TortaScheduler(r, seed=0, device="cpu"), seed=4,
                    device="cpu")
    legacy = Engine(p_topo, p_cs.copy(), p_wl,
                    TortaScheduler(r, seed=0, device="cpu"), seed=4,
                    device="cpu", batch_mode=False)
    assert not isinstance(native.scheduler, LegacySchedulerAdapter)
    assert isinstance(legacy.scheduler, LegacySchedulerAdapter)
    _same_summary(legacy.run(STICKY_SLOTS).summary(),
                  native.run(STICKY_SLOTS).summary())


def test_reset_clears_sticky_and_prediction_log():
    """reset() leaks neither sticky routing nor forecasts across runs."""
    *_, p_topo, p_cs, p_wl = _sticky_world()
    sched = TortaScheduler(p_topo.n_regions, seed=0, device="cpu",
                           distribution="sticky", micro_backend="numpy")
    s1 = Engine(p_topo, p_cs.copy(), p_wl, sched, seed=4,
                device="cpu").run(STICKY_SLOTS).summary()
    assert len(sched.prediction_log) == STICKY_SLOTS and sched._sticky
    s2 = Engine(p_topo, p_cs.copy(), p_wl, sched, seed=4,
                device="cpu").run(STICKY_SLOTS).summary()
    assert len(sched.prediction_log) == STICKY_SLOTS
    _same_summary(s2, s1)
    sched.reset()
    assert sched._sticky == {} and sched.prediction_log == []


def test_supports_batch_routes_through_adapter():
    """``distribution="sticky"`` opts out of the batch path: the engine
    wraps it in the adapter; ``"sample"`` passes through."""
    sample = TortaScheduler(3, device="cpu")
    sticky = TortaScheduler(3, device="cpu", distribution="sticky")
    assert sample.supports_batch and not sticky.supports_batch
    assert ensure_batch_scheduler(sample) is sample
    wrapped = ensure_batch_scheduler(sticky)
    assert isinstance(wrapped, LegacySchedulerAdapter)
    assert wrapped.wrapped is sticky and wrapped.name == "TORTA"
    *_, p_topo, p_cs, p_wl = _sticky_world()
    eng = Engine(p_topo, p_cs.copy(), p_wl,
                 TortaScheduler(p_topo.n_regions, device="cpu",
                                distribution="sticky"), device="cpu")
    assert isinstance(eng.scheduler, LegacySchedulerAdapter)
    assert eng.run(2).summary()["completed"] > 0
