"""The port's per-region micro routes on the CPU (plain kernel versions)
against the JAX package:

* ``backend="jax"`` (the greedy kernel one region at a time) is held
  exactly to the numpy oracle ``MicroAllocator(backend="numpy")`` in this
  process, and to the JAX ``jax`` route, uids included, in a separate
  process (``_jax_fused_ref.py``; that route needs the ``enable_x64``
  alias);
* the host walk (``backend="numpy"``/``"pallas"``) and its
  ``LocalityState`` are held bitwise to the reference's, the ``pallas``
  walk exactly when both are given the same float32 matrix;
* whole ``TortaScheduler`` runs on abilene: exact for ``jax``; within the
  reference's own float32 contract (completed rel 0.02, mean response
  rel 0.1) for ``pallas`` and ``jax`` with the fused score kernel, whose
  float32 matrices differ from the Pallas kernels' in the last ulp.
"""
import numpy as np
import pytest
import torch

from _torch_port import (Recorder, port_batch, port_failures, port_obs,
                         port_state, port_topology, ref_failures, ref_obs,
                         run_jax_fused, slice_case, sweep_slots, world)
from repro.core.micro import MicroAllocator as RefMicro
from repro.core.micro import batched_score_matrix as ref_batched_score_matrix
from repro.core.micro_state import LocalityState as RefLocalityState
from repro.core.torta import TortaScheduler as RefTorta
from repro.kernels.compat_score import compat_score as jax_compat
from repro.sim import Engine as RefEngine
from repro_torch import interop
from repro_torch.core import micro
from repro_torch.core.micro import MicroAllocator
from repro_torch.core.micro_state import LocalityState
from repro_torch.core.torta import TortaScheduler
from repro_torch.sim.engine import Engine

SWEEP = [(1, 3, 0), (1, 17, 4096), (2, 8, 17), (3, 3, 1234), (3, 17, 77),
         (4, 8, 9_999), (5, 3, 31), (5, 17, 2024)]
RING_FIELDS = ("mids", "slots", "embeds", "norms", "count")


def _assert_rings_equal(ref, got, j, fields=RING_FIELDS):
    if ref is None:
        assert got is None, f"region {j}"
        return
    for name in fields:
        a, b = getattr(ref, name), getattr(got, name)
        np.testing.assert_array_equal(b, a, err_msg=f"region {j} {name}")
        assert a.dtype == b.dtype, f"region {j} {name}"


def _per_region(port, r, spr, seed, ref=None):
    """Assign the sweep region by region with the port (and the reference
    when given); returns {(t, j): (port out, reference out or None)}."""
    outs = {}
    for t, cs, batch, region_of in sweep_slots(r, spr, seed):
        obs = ref_obs(cs, t)
        p_obs, p_batch = port_obs(obs), port_batch(batch)
        for j in range(r):
            idx = np.flatnonzero(region_of == j)
            if idx.size:
                outs[t, j] = (port.assign_batch(p_obs, j, p_batch, idx),
                              None if ref is None
                              else ref.assign_batch(obs, j, batch, idx))
    return outs


@pytest.mark.parametrize("backend", ["jax", "numpy"])
@pytest.mark.parametrize("r,spr,seed", SWEEP)
def test_per_region_route_matches_numpy_oracle(r, spr, seed, backend):
    """Identical assignments region by region over 3 slots (rings carried,
    zero-task and all-inactive regions included) and identical rings."""
    ref = RefMicro(backend="numpy")
    port = MicroAllocator(backend=backend, device="cpu")
    for (t, j), (got, want) in _per_region(port, r, spr, seed, ref).items():
        np.testing.assert_array_equal(got, want, err_msg=f"slot {t} "
                                      f"region {j}")
    fields = RING_FIELDS + (("uid",) if backend == "numpy" else ())
    for j in range(r):
        _assert_rings_equal(ref.locality_state(j), port.locality_state(j), j,
                            fields)


def test_jax_route_matches_jax_scan(tmp_path):
    """One sweep case against ``micro_jax.assign_scan`` itself: identical
    assignments, and rings equal in every field, uids included (the same
    write-back arithmetic)."""
    r, spr, seed = 4, 8, 9_999
    ref = run_jax_fused(tmp_path, "scan", str(r), str(spr), str(seed), "0")
    port = MicroAllocator(backend="jax", device="cpu")
    for (t, j), (got, _) in _per_region(port, r, spr, seed).items():
        np.testing.assert_array_equal(got, ref[f"out_{t}_{j}"],
                                      err_msg=f"slot {t} region {j}")
    for j in range(r):
        got = port.locality_state(j)
        if f"mids_{j}" not in ref:
            assert got is None, f"region {j}"
            continue
        for name in RING_FIELDS + ("uid",):
            np.testing.assert_array_equal(getattr(got, name),
                                          ref[f"{name}_{j}"],
                                          err_msg=f"region {j} {name}")


@pytest.mark.parametrize("r,spr,seed", [(1, 17, 4096), (3, 17, 77),
                                        (5, 17, 2024)])
def test_pallas_walk_matches_reference_on_same_matrix(r, spr, seed,
                                                      monkeypatch):
    """Given the Pallas kernel's own float32 matrix, the port's
    ``pallas`` walk assigns and notes exactly as the reference's."""
    def pallas_matrix(tf, sf, locality=None):
        return torch.from_numpy(np.asarray(jax_compat(
            tf.numpy(), sf.numpy(), interpret=True)))
    monkeypatch.setattr(micro, "score_matrix", pallas_matrix)
    ref = RefMicro(backend="pallas")
    port = MicroAllocator(backend="pallas", device="cpu")
    for (t, j), (got, want) in _per_region(port, r, spr, seed, ref).items():
        np.testing.assert_array_equal(got, want, err_msg=f"slot {t} "
                                      f"region {j}")
    for j in range(r):
        _assert_rings_equal(ref.locality_state(j), port.locality_state(j), j,
                            RING_FIELDS + ("uid",))


def test_pallas_matrix_within_float32_of_oracle():
    """The ``pallas`` route's hw+load matrix (plain ``compat_score``,
    float32 widened) against the float64 oracle and the Pallas kernel;
    ``batched_score_matrix`` adds the locality term on the host."""
    cs, rng = world(1, 17, 4096)
    tf = micro.task_feature_arrays(rng.integers(0, 3, 40).astype(np.int8),
                                   rng.uniform(1.0, 80.0, 40))
    sf = micro.server_feature_matrix(port_state(cs), cs.region_slice(0),
                                     45.0)
    got = micro.hw_load_matrix(tf, sf, backend="pallas", device="cpu")
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, micro.hw_load_matrix_np(tf, sf),
                               atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(
        got, np.asarray(jax_compat(tf.astype(np.float32),
                                   sf.astype(np.float32), interpret=True)),
        atol=1e-6, rtol=0)
    loc = rng.random((40, cs.n_servers))
    np.testing.assert_array_equal(
        micro.batched_score_matrix(tf, sf, loc, backend="pallas",
                                   device="cpu"), got + micro.W_LOC * loc)
    np.testing.assert_array_equal(
        micro.batched_score_matrix(tf, sf, loc, backend="numpy"),
        ref_batched_score_matrix(tf, sf, loc, backend="numpy"))


@pytest.mark.parametrize("seed,width", [(0, 8), (1, 3), (2, 16)])
def test_locality_state_note_and_column_match_reference(seed, width):
    """``note`` (embeddings narrower than the ring, ``None``, NO_MODEL
    ids) and ``column`` with and without the uid cache, bitwise."""
    rng = np.random.default_rng(seed)
    s, n = 6, 25
    ref, port = RefLocalityState.empty(s, 4, 8), LocalityState.empty(s, 4, 8)
    ref, port = ref.grown(width), port.grown(width)
    mids = rng.integers(-1, 6, n).astype(np.int16)
    embeds = rng.standard_normal((n, width)).astype(np.float32)
    has = rng.random(n) > 0.3
    embeds[~has] = 0.0
    norms = np.linalg.norm(embeds, axis=1)
    ref_cache, port_cache = {}, {}
    for uid in range(1, 40):
        srv = int(rng.integers(0, s))
        mid = int(rng.integers(-1, 6))
        k = int(rng.integers(1, width + 1))
        emb = None if rng.random() < 0.25 else \
            rng.standard_normal(k).astype(np.float32)
        t = int(rng.integers(0, 50))
        ref.note(srv, mid, emb, t, uid)
        port.note(srv, mid, emb, t, uid)
        for col in range(s):
            args = (col, mids, embeds, norms, has, t + 3)
            np.testing.assert_array_equal(port.column(*args),
                                          ref.column(*args))
            np.testing.assert_array_equal(
                port.column(*args, cache=port_cache),
                ref.column(*args, cache=ref_cache))
    for name in RING_FIELDS + ("uid",):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))


# ------------------------------------------------------- whole runs


def _port_run(case, slots, **kw):
    c = slice_case(case)
    rec = Recorder(TortaScheduler(c.topo.n_regions, seed=0, device="cpu",
                                  **kw))
    summary = Engine(port_topology(c.topo), c.port_cs, c.port_workload, rec,
                     failures=port_failures(c.failures), step_backend="torch",
                     device="cpu").run(slots).summary()
    return [d[:2] for d in rec.decisions], summary


def _ref_run(case, slots, **kw):
    c = slice_case(case)
    rec = Recorder(RefTorta(c.topo.n_regions, seed=0,
                            use_sinkhorn_kernel=True, **kw))
    summary = RefEngine(c.topo, c.cs.copy(), c.workload, rec, seed=0,
                        failures=ref_failures(c.failures),
                        step_backend="numpy").run(slots).summary()
    return [d[:2] for d in rec.decisions], summary


def _assert_same_run(got, want):
    (got_dec, got_sum), (want_dec, want_sum) = got, want
    assert len(got_dec) == len(want_dec)
    for t, ((gr, gs), (wr, ws)) in enumerate(zip(got_dec, want_dec)):
        np.testing.assert_array_equal(gr, wr, err_msg=f"slot {t} region")
        np.testing.assert_array_equal(gs, ws, err_msg=f"slot {t} server")
    for k, v in want_sum.items():
        assert float(got_sum[k]) == v or (np.isnan(got_sum[k])
                                          and np.isnan(v)), k


def _assert_float32_contract(got_sum, want_sum):
    assert got_sum["completed"] == pytest.approx(want_sum["completed"],
                                                 rel=0.02)
    assert got_sum["mean_response_s"] == pytest.approx(
        want_sum["mean_response_s"], rel=0.1)


def _ref_route(tmp_path, backend, fused, slots):
    ref = run_jax_fused(tmp_path, "route", "abilene", backend, str(fused),
                        str(slots))
    summary = dict(zip(ref["summary_keys"].tolist(),
                       ref["summary_vals"].tolist()))
    return [(ref[f"region_{t}"], ref[f"server_{t}"])
            for t in range(slots)], summary


def test_jax_route_end_to_end_matches_numpy_oracle():
    _assert_same_run(_port_run("abilene", 8, micro_backend="jax"),
                     _ref_run("abilene", 8))


def test_jax_route_end_to_end_matches_jax_scan(tmp_path):
    _assert_same_run(_port_run("abilene", 8, micro_backend="jax"),
                     _ref_route(tmp_path, "jax", 0, 8))


def test_jax_fused_kernel_route_end_to_end(tmp_path):
    _, got = _port_run("abilene", 5, micro_backend="jax",
                       micro_fused_kernel=True)
    _, want = _ref_route(tmp_path, "jax", 1, 5)
    _assert_float32_contract(got, want)


def test_pallas_route_end_to_end():
    _, got = _port_run("abilene", 6, use_compat_kernel=True)
    _, want = _ref_run("abilene", 6, use_compat_kernel=True)
    _assert_float32_contract(got, want)


def test_jax_route_equals_fused_route():
    """The greedy one region at a time and all regions in one launch make
    the same decisions (both are exact to the numpy oracle)."""
    _assert_same_run(_port_run("abilene", 8, micro_backend="jax"),
                     _port_run("abilene", 8))


def test_backend_resolution():
    assert TortaScheduler(2, device="cpu").micro.backend == "fused"
    assert TortaScheduler(2, use_compat_kernel=True,
                          device="cpu").micro.backend == "pallas"
    sched = TortaScheduler(2, micro_backend="jax", micro_fused_kernel=True,
                           device="cpu")
    assert (sched.micro.backend, sched.micro.fused) == ("jax", True)
    with pytest.raises(ValueError, match="unknown micro backend"):
        TortaScheduler(2, micro_backend="xla", device="cpu")


def test_port_continues_from_reference_locality_state():
    """``interop.locality_state_from_arrays`` carries the oracle's rings
    into the port: the export round-trips, and the next slot of the
    ``jax`` route assigns and notes as the oracle does."""
    r, spr, seed = 3, 8, 42
    ref = RefMicro(backend="numpy")
    port = MicroAllocator(backend="jax", device="cpu")
    for t, cs, batch, region_of in sweep_slots(r, spr, seed, n_slots=2):
        obs = ref_obs(cs, t)
        for j in range(r):
            idx = np.flatnonzero(region_of == j)
            if not idx.size:
                continue
            want = ref.assign_batch(obs, j, batch, idx)
            if t == 1:
                got = port.assign_batch(port_obs(obs), j, port_batch(batch),
                                        idx)
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"region {j}")
        if t == 0:
            for j in range(r):
                st = ref.locality_state(j)
                if st is None:
                    continue
                port._loc[j] = interop.locality_state_from_arrays(
                    **{name: getattr(st, name)
                       for name in RING_FIELDS + ("uid",)})
                _assert_rings_equal(st, port.locality_state(j), j,
                                    RING_FIELDS + ("uid",))
            port._uid = ref._uid
    for j in range(r):
        _assert_rings_equal(ref.locality_state(j), port.locality_state(j), j)
