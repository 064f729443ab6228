"""The whole slice: the port's ``Engine(step_backend="torch")`` driving its
``TortaScheduler(micro_backend="fused")`` on the CPU (plain versions of
both kernels), against the JAX package with the same seeds:

* ``Engine(step_backend="numpy")`` + ``TortaScheduler(use_sinkhorn_kernel=
  True)``, in this process;
* the fused JAX path (``micro_backend="fused"``, ``step_backend="jax"``,
  ``use_sinkhorn_kernel=True``), in a separate process.

Per-slot region/server decisions must be identical and the summaries
equal (rtol 0).  Region sampling draws from A_t, whose float32 OT plan
may differ from the reference's in the last bits; a flipped draw would
need a uniform within ~1e-7 of a cdf boundary, and is reported as such.
"""
import numpy as np
import pytest

from _torch_port import (SLICE_CASES, SLICE_SLOTS, Recorder, port_failures,
                         port_topology, ref_failures, run_jax_fused,
                         slice_case)
from repro.core.torta import TortaScheduler as RefTorta
from repro.sim import Engine as RefEngine
from repro_torch.core.torta import TortaScheduler
from repro_torch.sim.engine import Engine


def _port(case):
    c = slice_case(case)
    rec = Recorder(TortaScheduler(c.topo.n_regions, seed=0,
                                  micro_backend="fused", device="cpu"))
    summary = Engine(port_topology(c.topo), c.port_cs, c.port_workload, rec,
                     failures=port_failures(c.failures), step_backend="torch",
                     device="cpu").run(SLICE_SLOTS).summary()
    return rec.decisions, summary


def _check_decisions(got, want_region, want_server):
    assert len(got) == len(want_region) == SLICE_SLOTS
    for t, (region, server, _, _) in enumerate(got):
        flipped = np.flatnonzero((region != want_region[t])
                                 & (region >= 0) & (want_region[t] >= 0))
        assert flipped.size == 0, (
            f"slot {t}: sampled region differs on rows {flipped[:10]} — a "
            "float32 plan ulp next to an rng.choice cdf boundary")
        np.testing.assert_array_equal(region, want_region[t],
                                      err_msg=f"slot {t} region")
        np.testing.assert_array_equal(server, want_server[t],
                                      err_msg=f"slot {t} server")


def _check_summary(got, want):
    for k, v in want.items():
        assert got[k] == v or (np.isnan(got[k]) and np.isnan(v)), k


@pytest.mark.parametrize("case", SLICE_CASES)
def test_slice_matches_reference_numpy_path(case):
    c = slice_case(case)
    rec = Recorder(RefTorta(c.topo.n_regions, seed=0,
                            use_sinkhorn_kernel=True))
    want = RefEngine(c.topo, c.cs.copy(), c.workload, rec, seed=0,
                     failures=ref_failures(c.failures),
                     step_backend="numpy").run(SLICE_SLOTS).summary()
    got_dec, got = _port(case)
    _check_decisions(got_dec, [d[0] for d in rec.decisions],
                     [d[1] for d in rec.decisions])
    _check_summary(got, want)


@pytest.mark.parametrize("case", SLICE_CASES)
def test_slice_matches_fused_jax_path(case, tmp_path):
    ref = run_jax_fused(tmp_path, "slice", case)
    want = dict(zip(ref["summary_keys"].tolist(),
                    ref["summary_vals"].tolist()))
    got_dec, got = _port(case)
    _check_decisions(got_dec, [ref[f"region_{t}"] for t in range(SLICE_SLOTS)],
                     [ref[f"server_{t}"] for t in range(SLICE_SLOTS)])
    _check_summary({k: float(v) for k, v in got.items()}, want)
