"""Shared helpers of the ``test_torch_*`` parity tests: seeded worlds built
with the JAX package, their conversion into the port's types, decision
recording/replay, and the subprocess that runs the JAX package's fused
path (``_jax_fused_ref.py``)."""
from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess
import sys

import networkx as nx
import numpy as np

from repro.sim import make_cluster_state, make_topology, make_workload
from repro.sim.cluster import throughput_per_slot
from repro.sim.engine import FailureEvent, SlotObs
from repro.sim.state import ACTIVE, MODEL_NAMES, OFF
from repro.sim.topology import Topology
from repro.workload import make_source
from repro_torch import interop
from repro_torch.sim import engine as p_engine
from repro_torch.sim.state import make_cluster_state as p_make_cluster_state
from repro_torch.sim.topology import Topology as PortTopology
from repro_torch.workload import StreamingWorkload, TaskBatch, make_workload as p_make_workload
from repro_torch.workload.legacy import generate_traffic

TESTS = pathlib.Path(__file__).resolve().parent
N_MODELS = len(MODEL_NAMES)


# ------------------------------------------------------------ conversions


def port_state(cs):
    """The port's ``ClusterState`` with every field of the reference's."""
    return interop.cluster_state_from_arrays(
        **{f.name: getattr(cs, f.name) for f in dataclasses.fields(cs)})


def port_batch(batch) -> TaskBatch:
    return TaskBatch(**{f.name: getattr(batch, f.name)
                        for f in dataclasses.fields(batch)})


def port_topology(topo) -> PortTopology:
    return PortTopology(topo.name, topo.n_regions, topo.bandwidth_gbps,
                        topo.latency)


def ref_obs(cs, t: int) -> SlotObs:
    r = cs.n_regions
    return SlotObs(t=t, latency=np.zeros((r, r)),
                   capacities=cs.capacities(),
                   total_capacities=cs.total_capacities(),
                   queue_s=cs.queue_by_region(),
                   queue_tasks=np.zeros(r), utilization=cs.utilizations(),
                   power_prices=cs.power_prices(),
                   prev_alloc=np.full((r, r), 1.0 / r),
                   arrivals_history=np.zeros((0, r)), state=cs,
                   slot_seconds=45.0)


def port_obs(obs) -> "p_engine.SlotObs":
    fields = {f.name: getattr(obs, f.name)
              for f in dataclasses.fields(p_engine.SlotObs)}
    fields["state"] = port_state(obs.state)
    return p_engine.SlotObs(**fields)


# ----------------------------------------------------------------- worlds


def synth_topology(r: int, seed: int = 0) -> Topology:
    rng = np.random.default_rng(seed)
    lat = rng.uniform(10, 80, (r, r))
    lat = (lat + lat.T) / 2
    np.fill_diagonal(lat, 0.0)
    return Topology(name=f"synth{r}", n_regions=r, bandwidth_gbps=10,
                    latency=lat, graph=nx.cycle_graph(r))


def world(r: int, spr: int, seed: int):
    """Randomized multi-region fleet (the sweep of the fused-step tests)."""
    rng = np.random.default_rng(seed)
    cs = make_cluster_state(r, seed=seed % 50,
                            servers_per_region=(spr, spr + 1))
    s = cs.n_servers
    cs.state[:] = np.where(rng.random(s) < 0.75, ACTIVE, OFF).astype(np.int8)
    cs.queue_s[:] = rng.exponential(30.0, s)
    cs.util[:] = rng.random(s)
    cs.current_model[:] = rng.integers(-1, N_MODELS, s).astype(np.int16)
    cs.warm_models[:] = rng.integers(
        -1, N_MODELS, cs.warm_models.shape).astype(np.int16)
    if r > 1:
        cs.state[cs.region_slice(r - 1)] = OFF       # all-inactive region
    return cs, rng


def sweep_slots(r: int, spr: int, seed: int, n_slots: int = 3):
    """Yield ``(t, cs, batch, region_of)`` for the randomized sweep: one
    fleet, ``n_slots`` slots of diurnal demand routed to random regions,
    with a zero-task region in slot 1."""
    cs, rng = world(r, spr, seed)
    src = make_source("diurnal", n_slots, r, seed=seed % 97, base_rate=10.0)
    for t in range(n_slots):
        batch = src.slot_batch(t)
        region_of = rng.integers(0, r, len(batch)).astype(np.int32)
        if r > 2 and t == 1:
            region_of[region_of == 1] = 0            # zero-task region
        yield t, cs, batch, region_of


SLICE_CASES = ("abilene", "15x40")
SLICE_SLOTS = 8


@dataclasses.dataclass
class SliceCase:
    """One end-to-end case, built twice from the same seeds: with the JAX
    package (``topo``, ``cs``, ``workload``) and with the port
    (``port_cs``, ``port_workload``).  ``failures`` are (region, start,
    duration) windows."""

    topo: Topology
    cs: object
    workload: object
    port_cs: object
    port_workload: object
    failures: list


def slice_case(name: str) -> SliceCase:
    if name == "abilene":
        topo = make_topology("abilene", seed=1)
        r, spr = topo.n_regions, (10, 18)
    elif name == "15x40":
        topo = synth_topology(15, seed=1)
        r, spr = 15, (40, 41)
    else:
        raise KeyError(name)
    cs = make_cluster_state(r, seed=3, servers_per_region=spr)
    rate = 0.3 * throughput_per_slot(cs) / r
    if name == "abilene":
        return SliceCase(
            topo, cs, make_workload(SLICE_SLOTS, r, seed=2, base_rate=rate),
            p_make_cluster_state(r, seed=3, servers_per_region=spr),
            p_make_workload(SLICE_SLOTS, r, seed=2, base_rate=rate),
            [(1, 3, 2)])
    return SliceCase(
        topo, cs, make_source("diurnal", SLICE_SLOTS, r, seed=2,
                              base_rate=rate),
        p_make_cluster_state(r, seed=3, servers_per_region=spr),
        StreamingWorkload(generate_traffic(SLICE_SLOTS, r, 2, base_rate=rate),
                          seed=2),
        [])


OBS_REGIONS, OBS_SLOTS = 5, 8


def obs_world(slots: int = OBS_SLOTS):
    """``tests/test_obs.py``'s ``_small_world`` (5 regions of 10 servers
    at 0.4 utilization, diurnal demand): (topology, fleet, workload) of
    the JAX package, and the port's workload from the same seeds."""
    from repro_torch.workload import make_source as p_make_source
    r = OBS_REGIONS
    topo = synth_topology(r, seed=1)
    cs = make_cluster_state(r, seed=3, servers_per_region=(10, 11))
    rate = 0.4 * throughput_per_slot(cs) / r
    return (topo, cs, make_source("diurnal", slots, r, seed=2,
                                  base_rate=rate),
            p_make_source("diurnal", slots, r, seed=2, base_rate=rate))


def ref_failures(windows):
    return [FailureEvent(*w) for w in windows]


def port_failures(windows):
    return [p_engine.FailureEvent(*w) for w in windows]


# ------------------------------------------------------ record / replay


class Recorder:
    """Wraps a scheduler and keeps a copy of every decision it makes."""

    def __init__(self, inner):
        self.inner = inner
        self.name = inner.name
        self.decisions = []

    def reset(self):
        self.inner.reset()
        self.decisions = []

    def schedule_batch(self, obs, batch):
        d = self.inner.schedule_batch(obs, batch)
        self.decisions.append((np.array(d.region), np.array(d.server),
                               np.array(d.activation), np.array(batch.ids)))
        return d


class Replay:
    """Answers each slot with a recorded decision (checking that the batch
    is the one it was made for)."""

    name = "replay"

    def __init__(self, decisions, decision_cls):
        self.decisions = decisions
        self.decision_cls = decision_cls
        self.t = 0

    def reset(self):
        self.t = 0

    def schedule_batch(self, obs, batch):
        region, server, activation, ids = self.decisions[self.t]
        np.testing.assert_array_equal(batch.ids, ids,
                                      err_msg=f"slot {self.t} batch")
        self.t += 1
        return self.decision_cls(region=region, server=server,
                                 activation=activation)


# ------------------------------------------------------ fused subprocess


def run_jax_fused(tmp_path: pathlib.Path, *args: str) -> dict:
    """Run ``_jax_fused_ref.py`` in a fresh interpreter (the JAX package's
    fused modules need the ``enable_x64`` alias, which must stay out of
    the test process) and return its ``.npz`` results."""
    out = tmp_path / "ref.npz"
    env = dict(os.environ)
    src = str(TESTS.parent / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    proc = subprocess.run(
        [sys.executable, str(TESTS / "_jax_fused_ref.py"), *args, str(out)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(out) as data:
        return dict(data)
