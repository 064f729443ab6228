"""Members of ported modules held to the JAX package's on the CPU: the
demand sources' ``slot_counts`` / ``slot_tasks`` / ``arrivals_matrix``,
``MetricsAggregator.drops_series``, ``ClusterState.gidx`` /
``switch_cost_vec`` / ``switch_cost_matrix``, ``PPOTrainer.act`` and
``TaskBatch.embed_dim``.  Everything but ``act`` is numpy on both sides
and must be equal exactly; ``act`` is the float32 policy, held to
``tests/test_torch_rl.py``'s policy tolerance (1e-5)."""
import dataclasses
import types

import jax
import numpy as np
import pytest

from repro.baselines.rr import RoundRobinScheduler as RefRR
from repro.core import env as r_env
from repro.core import ppo as r_ppo
from repro.sim import Engine as RefEngine
from repro.sim import make_cluster_state as ref_make_cluster_state
from repro.sim.cluster import throughput_per_slot
from repro.workload import LegacySource as RefLegacySource
from repro.workload import StreamingWorkload as RefStreaming
from repro.workload import TaskBatch as RefTaskBatch
from repro.workload import make_workload as ref_make_workload
from repro.workload.legacy import generate_traffic as ref_generate_traffic
from repro_torch import interop
from repro_torch.baselines.rr import RoundRobinScheduler
from repro_torch.core import env as p_env
from repro_torch.core import ppo as p_ppo
from repro_torch.sim.engine import Engine
from repro_torch.sim.state import MODEL_NAMES, make_cluster_state
from repro_torch.workload import (LegacySource, StreamingWorkload, TaskBatch,
                                  make_workload)
from repro_torch.workload.legacy import generate_traffic

from _torch_port import port_topology, synth_topology

R, SERVERS, SLOTS = 15, 40, 8


def _traffic(seed=2):
    return generate_traffic(SLOTS, R, seed, base_rate=20.0)


def _same_tasks(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
            else:
                assert a == b and type(a) is type(b), f.name


# ------------------------------------------------------------- sources


@pytest.mark.parametrize("seed", [0, 5])
def test_streaming_counts_tasks_and_arrivals_equal_reference(seed):
    traffic = _traffic()
    np.testing.assert_array_equal(traffic, ref_generate_traffic(
        SLOTS, R, 2, base_rate=20.0))
    got, want = (cls(traffic, seed=seed)
                 for cls in (StreamingWorkload, RefStreaming))
    for t in range(SLOTS):
        counts = got.slot_counts(t)
        np.testing.assert_array_equal(counts, want.slot_counts(t))
        assert counts.dtype == want.slot_counts(t).dtype
        # the same first draw as the full batch
        np.testing.assert_array_equal(
            counts, got.slot_batch(t).origin_counts(R))
        _same_tasks(got.slot_tasks(t), want.slot_tasks(t))
    arr = got.arrivals_matrix()
    np.testing.assert_array_equal(arr, want.arrivals_matrix())
    assert arr.dtype == np.float64 and arr.shape == (SLOTS, R)


def test_legacy_workload_and_source_equal_reference():
    got, want = make_workload(SLOTS, R, seed=4), ref_make_workload(SLOTS, R,
                                                                  seed=4)
    arr = got.arrivals_matrix()
    np.testing.assert_array_equal(arr, want.arrivals_matrix())
    assert arr.dtype == want.arrivals_matrix().dtype
    assert arr.sum() > 0
    src, ref_src = LegacySource(got), RefLegacySource(want)
    np.testing.assert_array_equal(src.arrivals_matrix(),
                                  ref_src.arrivals_matrix())
    for t in range(SLOTS):
        tasks = src.slot_tasks(t)
        _same_tasks(tasks, ref_src.slot_tasks(t))
        assert tasks is not got.tasks[t]      # a copy of the slot's list


def test_materialized_stream_arrivals_equal_reference():
    """A streaming source's legacy workload counts what it streamed."""
    got = StreamingWorkload(_traffic(), seed=1).materialize()
    want = RefStreaming(_traffic(), seed=1).materialize()
    np.testing.assert_array_equal(got.arrivals_matrix(),
                                  want.arrivals_matrix())
    np.testing.assert_array_equal(
        got.arrivals_matrix(),
        StreamingWorkload(_traffic(), seed=1).arrivals_matrix())


def test_embed_dim_equals_reference():
    for dim in (8, 3):
        got = StreamingWorkload(_traffic(), seed=0, embed_dim=dim)
        want = RefStreaming(_traffic(), seed=0, embed_dim=dim)
        assert got.slot_batch(1).embed_dim == want.slot_batch(1).embed_dim \
            == dim
        assert TaskBatch.empty(dim).embed_dim == \
            RefTaskBatch.empty(dim).embed_dim == dim


# --------------------------------------------------------------- metrics


def test_drops_series_after_engine_run_equals_reference():
    """RR on a 4-region fleet under twice its throughput, tasks dropped
    two slots after arrival: both engines' per-slot drops."""
    topo = synth_topology(4, seed=1)
    cs = ref_make_cluster_state(4, seed=3, servers_per_region=(6, 7))
    rate = 2.0 * throughput_per_slot(cs) / 4
    traffic = ref_generate_traffic(SLOTS, 4, 2, base_rate=rate)
    ref = RefEngine(topo, cs.copy(), RefStreaming(traffic, seed=2), RefRR(),
                    seed=0, drop_after_slots=2.0, step_backend="numpy")
    ref.run(SLOTS)
    port = Engine(port_topology(topo), make_cluster_state(
        4, seed=3, servers_per_region=(6, 7)),
        StreamingWorkload(traffic, seed=2), RoundRobinScheduler(), seed=0,
        drop_after_slots=2.0, device="cpu")
    port.run(SLOTS)
    want = ref.metrics.drops_series(SLOTS)
    assert want.sum() > 0
    for n in (SLOTS, SLOTS - 3, SLOTS + 2):
        got = port.metrics.drops_series(n)
        np.testing.assert_array_equal(got, ref.metrics.drops_series(n))
        assert got.dtype == np.int64


# ----------------------------------------------------------------- state


def _warm_states(seed=7):
    """The same 15x40 fleet in both packages, current and warm models
    drawn (NO_MODEL included) and some servers' warm lists holding their
    current model."""
    want = ref_make_cluster_state(R, seed=seed,
                                  servers_per_region=(SERVERS, SERVERS + 1))
    got = make_cluster_state(R, seed=seed,
                             servers_per_region=(SERVERS, SERVERS + 1))
    rng = np.random.default_rng(seed)
    s, m = want.n_servers, len(MODEL_NAMES)
    cur = rng.integers(-1, m, s).astype(np.int16)
    warm = rng.integers(-1, m, want.warm_models.shape).astype(np.int16)
    warm[::5, 0] = cur[::5]
    for cs in (got, want):
        cs.current_model[:] = cur
        cs.warm_models[:] = warm
    return got, want


def test_gidx_equals_reference():
    got, want = _warm_states()
    for r in range(R):
        for j in range(int(want.region_sizes()[r])):
            assert got.gidx(r, j) == want.gidx(r, j) == \
                want.region_slice(r).start + j
    assert type(got.gidx(2, 3)) is int


def test_switch_cost_vec_equals_reference():
    got, want = _warm_states()
    for mid in range(-1, len(MODEL_NAMES)):
        v = got.switch_cost_vec(mid)
        np.testing.assert_array_equal(v, want.switch_cost_vec(mid))
        assert v.dtype == np.float64
        # the per-server scalar form, server by server
        np.testing.assert_array_equal(
            v, [got.switch_cost(g, mid) for g in range(got.n_servers)])


@pytest.mark.parametrize("region", [None, 0, 6, R - 1])
def test_switch_cost_matrix_equals_reference(region):
    got, want = _warm_states()
    mids = np.random.default_rng(9).integers(0, len(MODEL_NAMES), 37)
    mids = mids.astype(np.int16)
    sl = None if region is None else want.region_slice(region)
    mat = got.switch_cost_matrix(mids, sl)
    np.testing.assert_array_equal(mat, want.switch_cost_matrix(mids, sl))
    n_cols = got.n_servers if sl is None else sl.stop - sl.start
    assert mat.shape == (37, n_cols) and mat.dtype == np.float64
    # row i is the vector form for task i's model, over the slice
    for i in (0, 17, 36):
        want_row = got.switch_cost_vec(int(mids[i]))
        np.testing.assert_array_equal(
            mat[i], want_row if sl is None else want_row[sl])


# ------------------------------------------------------------------- PPO


def test_ppo_act_equals_reference_on_bridged_weights():
    """The port trainer's initial policy, its last layer scaled up 100x so
    the Betas are far from uniform, in both packages (through the
    ``interop`` bridges); ``act`` on float64 and float32 observations,
    one row and many.  The reference's ``act`` reads only the trainer's
    ``params`` and ``n_regions``, so it runs on a stand-in holding those
    (building its trainer would initialise a second policy in JAX)."""
    r = 5
    port = p_ppo.PPOTrainer(p_env.make_env_params(
        np.full(r, 40.0), np.ones(r), np.full((r, r), 10.0),
        np.full((8, r), 30.0), device="cpu"), r, seed=0, device="cpu")
    tree = interop.policy_params_to_arrays(port.net)
    tree["policy"][-1]["w"] = tree["policy"][-1]["w"] * 100
    port.net = interop.policy_params_from_arrays(tree, r, device="cpu")
    ref = types.SimpleNamespace(params=jax.tree.map(jax.numpy.asarray, tree),
                                n_regions=r)
    obs = np.random.default_rng(2).random((7, r_env.obs_dim(r)))
    for o in (obs, obs.astype(np.float32), obs[0]):
        got, want = port.act(o), r_ppo.PPOTrainer.act(ref, o)
        assert isinstance(got, np.ndarray) and got.shape == want.shape
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    assert all(p.grad is None for p in port.net.parameters())
