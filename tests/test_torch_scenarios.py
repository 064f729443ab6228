"""The port's scenario registry and trace loading against the JAX
package's: every registered scenario gives the same traffic matrix and
the same first ``TaskBatch``es for the same seed, and traces load and
resample to the same arrays."""
import dataclasses
import json

import numpy as np
import pytest

from repro.workload import (get_scenario as ref_get_scenario,
                            load_trace as ref_load_trace,
                            make_source as ref_make_source,
                            resample_trace as ref_resample_trace,
                            to_legacy_workload as ref_to_legacy_workload)
from repro.workload.batch import group_rows as ref_group_rows
from repro_torch.workload import (TaskBatch, get_scenario, group_rows,
                                  list_scenarios, load_trace, make_source,
                                  make_workload, register_scenario,
                                  resample_trace, to_legacy_workload)

SLOTS, REGIONS, BATCHES = 24, 12, 3
CASES = [(name, seed) for name in list_scenarios() for seed in (0, 5)]


def _assert_batches_equal(got, want, what):
    assert type(got).__name__ == "TaskBatch"
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert g.dtype == w.dtype, (what, f.name)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {f.name}")


@pytest.mark.parametrize("name,seed", CASES,
                         ids=[f"{n}-{s}" for n, s in CASES])
def test_scenario_matches_reference(name, seed):
    kw = dict(base_rate=4.0)
    if name == "trace_replay":
        kw["resample_mix"] = True
    got = make_source(name, SLOTS, REGIONS, seed, **kw)
    want = ref_make_source(name, SLOTS, REGIONS, seed, **kw)
    assert got.name == want.name == name
    np.testing.assert_array_equal(got.traffic, want.traffic)
    np.testing.assert_array_equal(got.model_mix, want.model_mix)
    for t in range(BATCHES):
        _assert_batches_equal(got.slot_batch(t), want.slot_batch(t),
                              f"{name} slot {t}")


def test_scenario_registry():
    with pytest.raises(KeyError, match="unknown scenario"):
        get_scenario("nope")
    with pytest.raises(ValueError, match="already registered"):
        register_scenario("diurnal")(lambda *a, **k: None)
    with pytest.raises(ValueError, match=">= 2 regions"):
        make_source("regional_outage", 4, 1)
    # the outage moves demand between regions and keeps each slot's total
    out = make_source("regional_outage", SLOTS, 4, 1, outage_region=2)
    base = make_source("diurnal", SLOTS, 4, 1)
    np.testing.assert_allclose(out.traffic.sum(1), base.traffic.sum(1),
                               rtol=1e-12)
    assert out.traffic[int(0.4 * SLOTS) + 3, 2] == 0.0


@pytest.fixture
def trace_files(tmp_path):
    rng = np.random.default_rng(0)
    arr = rng.uniform(0.0, 30.0, (9, 5))
    csv = tmp_path / "trace.csv"
    csv.write_text("slot,a,b,c,d,e\n" + "\n".join(
        ",".join([str(i)] + [repr(float(x)) for x in row])
        for i, row in enumerate(arr)) + "\n")
    bare = tmp_path / "bare.csv"
    bare.write_text("\n".join(",".join(repr(float(x)) for x in row)
                              for row in arr))
    js = tmp_path / "trace.json"
    js.write_text(json.dumps({"arrivals": arr.tolist(), "interval_s": 60,
                              "model_mix": [3.0, 1.0, 1.0, 2.0, 1.0, 1.0]}))
    return csv, bare, js


def test_load_trace_matches_reference(trace_files, tmp_path):
    for path in trace_files:
        got, got_meta = load_trace(path)
        want, want_meta = ref_load_trace(path)
        np.testing.assert_array_equal(got, want)
        assert got_meta == want_meta
    bad = tmp_path / "neg.csv"
    bad.write_text("1,2\n-1,3\n")
    with pytest.raises(ValueError, match="negative"):
        load_trace(bad)
    # a trace from a file replays as the reference replays it
    path = trace_files[2]
    np.testing.assert_array_equal(
        make_source("trace_replay", 16, 7, 3, path=path).traffic,
        ref_make_source("trace_replay", 16, 7, 3, path=path).traffic)


@pytest.mark.parametrize("shape", [(9, 5), (20, 5), (9, 3), (4, 12),
                                   (30, 2)])
def test_resample_trace_matches_reference(shape):
    arr = np.random.default_rng(1).uniform(0.0, 10.0, (9, 5))
    got = resample_trace(arr, *shape)
    np.testing.assert_array_equal(got, ref_resample_trace(arr, *shape))
    assert got.shape == shape
    np.testing.assert_allclose(got.sum(1), resample_trace(arr, shape[0],
                                                          5).sum(1))


def test_group_rows_and_legacy_round_trip():
    keys = np.random.default_rng(2).integers(0, 7, 200)
    got = [(gi, k, rows.tolist()) for gi, k, rows in group_rows(keys)]
    assert got == [(gi, k, rows.tolist())
                   for gi, k, rows in ref_group_rows(keys)]
    src = make_source("flash_crowd", 6, 4, 3, base_rate=5.0)
    ref_src = ref_make_source("flash_crowd", 6, 4, 3, base_rate=5.0)
    wl, ref_wl = to_legacy_workload(src), ref_to_legacy_workload(ref_src)
    for t in range(6):
        assert [dataclasses.astuple(task)[:-1] for task in wl.tasks[t]] == \
            [dataclasses.astuple(task)[:-1] for task in ref_wl.tasks[t]]
        _assert_batches_equal(TaskBatch.from_tasks(wl.tasks[t]),
                              src.slot_batch(t), f"round trip slot {t}")
    legacy = make_workload(3, 4, seed=1)
    assert to_legacy_workload(legacy) is legacy
    assert ref_get_scenario("multiday").__name__ == \
        get_scenario("multiday").__name__
