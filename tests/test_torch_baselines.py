"""The paper's comparison on the CPU: the port's five baselines, and TORTA
on the larger named topologies, through ``Engine(step_backend="torch")``
against the JAX package's ``Engine(step_backend="numpy")`` with the same
seeds, as ``benchmarks/common.py``'s ``run_matrix`` builds them.

Per-slot region/server decisions must be identical and the summaries
equal (rtol 0).  ReactiveOT and TORTA sample regions from a float32 OT
plan, which the reference computes with its Sinkhorn kernel
(``use_sinkhorn_kernel=True``); a flipped draw would need a uniform
within ~1e-7 of a cdf boundary, and is reported as such.  The legacy
``schedule()`` path (``LegacyOnlyView`` and ``batch_mode=False``) must
equal the native run, regional outage included.
"""
import numpy as np
import pytest

from _torch_port import Recorder, port_failures, ref_failures
from repro.baselines import (MilpScheduler as RefMilp,
                             ReactiveOTScheduler as RefReactiveOT,
                             RoundRobinScheduler as RefRR,
                             SDIBScheduler as RefSDIB,
                             SkyLBScheduler as RefSkyLB)
from repro.core.torta import TortaScheduler as RefTorta
from repro.sim import Engine as RefEngine
from repro.sim import make_cluster_state, make_topology, make_workload
from repro.sim.cluster import throughput_per_slot
from repro_torch.api import (BatchDecision, LegacyOnlyView,
                             LegacySchedulerAdapter, ensure_batch_scheduler,
                             slot_to_batch_decision)
from repro_torch.baselines import (MilpScheduler, ReactiveOTScheduler,
                                   RoundRobinScheduler, SDIBScheduler,
                                   SkyLBScheduler)
from repro_torch.core.torta import TortaScheduler
from repro_torch.sim import make_topology as p_make_topology
from repro_torch.sim.engine import Engine
from repro_torch.sim.reference import ReferenceRoundRobinScheduler
from repro_torch.sim.state import make_cluster_state as p_make_cluster_state
from repro_torch.workload import TaskBatch
from repro_torch.workload import make_workload as p_make_workload

SLOTS = 8
TORTA_SLOTS = 4
OUTAGE = [(1, 3, 2)]             # region 1 down for slots 3-4


class RefReactiveOTKernel(RefReactiveOT):
    """The reference's ReactiveOT with its OT plan through the Sinkhorn
    kernel (the route the port always takes); set again after every
    ``reset()``, which rebuilds the macro allocator."""

    def __post_init__(self):
        super().__post_init__()
        self.macro.use_sinkhorn_kernel = True


BASELINES = {
    "SkyLB": (lambda r: RefSkyLB(), lambda r: SkyLBScheduler()),
    "SDIB": (lambda r: RefSDIB(), lambda r: SDIBScheduler()),
    "RR": (lambda r: RefRR(), lambda r: RoundRobinScheduler()),
    "ReactiveOT": (lambda r: RefReactiveOTKernel(r),
                   lambda r: ReactiveOTScheduler(r, device="cpu")),
    "MILP": (lambda r: RefMilp(r), lambda r: MilpScheduler(r)),
}


def _world(name: str, slots: int):
    """``run_matrix``'s cell: the named topology at seed 1, the paper's
    fleet (``make_cluster_state(R, seed=3)``), the legacy diurnal workload
    at 0.35 of the fleet's throughput; built by each package."""
    topo, p_topo = make_topology(name, seed=1), p_make_topology(name, seed=1)
    r = topo.n_regions
    cs = make_cluster_state(r, seed=3)
    rate = 0.35 * throughput_per_slot(cs) / r
    return (topo, cs, make_workload(slots, r, seed=2, base_rate=rate),
            p_topo, p_make_cluster_state(r, seed=3),
            p_make_workload(slots, r, seed=2, base_rate=rate))


class LegacyRecorder(Recorder):
    """A ``Recorder`` that also answers (and records) the legacy
    ``schedule(obs, tasks)`` call."""

    def schedule(self, obs, tasks):
        d = self.inner.schedule(obs, tasks)
        b = slot_to_batch_decision(d, TaskBatch.from_tasks(tasks))
        self.decisions.append((b.region, b.server,
                               np.array(b.activation), None))
        return d


def _run_ref(name, ref_sched, slots, failures=()):
    topo, cs, wl, *_ = _world(name, slots)
    rec = Recorder(ref_sched)
    summary = RefEngine(topo, cs.copy(), wl, rec, seed=4,
                        failures=ref_failures(failures),
                        step_backend="numpy").run(slots).summary()
    return rec, summary


def _run_port(name, sched, slots, failures=(), wrap=None, **engine_kw):
    *_, topo, cs, wl = _world(name, slots)
    rec = LegacyRecorder(sched)
    summary = Engine(topo, cs, wl, wrap(rec) if wrap else rec, seed=4,
                     failures=port_failures(failures), step_backend="torch",
                     device="cpu", **engine_kw).run(slots).summary()
    return rec, summary


def _check(got, want, slots):
    assert len(got.decisions) == len(want.decisions) == slots
    for t, (g, w) in enumerate(zip(got.decisions, want.decisions)):
        flipped = np.flatnonzero((g[0] != w[0]) & (g[0] >= 0) & (w[0] >= 0))
        assert flipped.size == 0, (
            f"slot {t}: sampled region differs on rows {flipped[:10]} — a "
            "float32 plan ulp next to an rng.choice cdf boundary")
        np.testing.assert_array_equal(g[0], w[0], err_msg=f"slot {t} region")
        np.testing.assert_array_equal(g[1], w[1], err_msg=f"slot {t} server")


def _check_summary(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == v or (np.isnan(got[k]) and np.isnan(v)), k


@pytest.mark.parametrize("name", sorted(BASELINES))
def test_baseline_matches_reference_on_abilene(name):
    ref_fn, port_fn = BASELINES[name]
    ref_sched, port_sched = ref_fn(12), port_fn(12)
    want_rec, want = _run_ref("abilene", ref_sched, SLOTS)
    got_rec, got = _run_port("abilene", port_sched, SLOTS)
    _check(got_rec, want_rec, SLOTS)
    _check_summary(got, want)
    assert got["completed"] > 0
    if name == "MILP":
        # decisions are pinned only where every solve ended optimal
        assert port_sched.statuses == [0] * SLOTS
    if name == "ReactiveOT":
        np.testing.assert_allclose(port_sched.switching_costs(),
                                   ref_sched.switching_costs(),
                                   rtol=1e-5, atol=1e-7)


LEGACY_CASES = {
    "SkyLB-view": ("SkyLB", dict(wrap=LegacyOnlyView)),
    "ReactiveOT-view": ("ReactiveOT", dict(wrap=LegacyOnlyView)),
    "SkyLB-batch_mode=False": ("SkyLB", dict(batch_mode=False)),
}


@pytest.mark.parametrize("case", sorted(LEGACY_CASES))
def test_legacy_path_matches_native_run_under_outage(case):
    name, kw = LEGACY_CASES[case]
    ref_fn, port_fn = BASELINES[name]
    want_rec, want = _run_ref("abilene", ref_fn(12), SLOTS, OUTAGE)
    native_rec, native = _run_port("abilene", port_fn(12), SLOTS, OUTAGE)
    got_rec, got = _run_port("abilene", port_fn(12), SLOTS, OUTAGE, **kw)
    # every slot of the legacy run went through schedule(obs, tasks)
    assert all(d[3] is None for d in got_rec.decisions)
    _check(native_rec, want_rec, SLOTS)
    _check(got_rec, native_rec, SLOTS)
    _check_summary(native, want)
    _check_summary(got, native)


def test_ensure_batch_scheduler_routes():
    sky = SkyLBScheduler()
    assert ensure_batch_scheduler(sky) is sky
    view = ensure_batch_scheduler(LegacyOnlyView(sky))
    assert isinstance(view, LegacySchedulerAdapter) and view.name == "SkyLB"
    assert isinstance(ensure_batch_scheduler(sky, force_adapter=True),
                      LegacySchedulerAdapter)

    class BatchOnly:
        name = "batch-only"

        def reset(self):
            pass

        def schedule_batch(self, obs, batch):
            n = len(batch)
            return BatchDecision(region=np.full(n, -1, np.int32),
                                 server=np.full(n, -1, np.int32))

    with pytest.raises(TypeError, match="batch-native only"):
        ensure_batch_scheduler(BatchOnly(), force_adapter=True)
    # TORTA has a legacy schedule(), so the adapter can be forced for it
    assert isinstance(ensure_batch_scheduler(TortaScheduler(2, device="cpu"),
                                             force_adapter=True),
                      LegacySchedulerAdapter)
    with pytest.raises(TypeError, match="neither"):
        ensure_batch_scheduler(object())
    # the object Cluster view builds and schedules (the frozen RR on it)
    cluster_view = LegacySchedulerAdapter(ReferenceRoundRobinScheduler(),
                                          obs_mode="cluster")
    *_, topo, cs, wl = _world("abilene", 2)
    summary = Engine(topo, cs, wl, cluster_view, seed=4,
                     device="cpu").run(2).summary()
    assert summary["completed"] > 0
    with pytest.raises(ValueError, match="obs_mode"):
        LegacySchedulerAdapter(sky, obs_mode="objects")


@pytest.mark.parametrize("name", ["gabriel", "cost2"])
def test_torta_matches_reference_on_named_topology(name):
    r = p_make_topology(name).n_regions
    want_rec, want = _run_ref(name, RefTorta(r, seed=0,
                                             use_sinkhorn_kernel=True),
                              TORTA_SLOTS)
    got_rec, got = _run_port(name, TortaScheduler(r, seed=0, device="cpu"),
                             TORTA_SLOTS)
    _check(got_rec, want_rec, TORTA_SLOTS)
    _check_summary(got, want)
