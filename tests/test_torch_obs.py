"""The port's observability tier (``repro_torch.obs``) and its engine
wiring, held to the JAX package's ``repro.obs`` and ``repro.sim.engine``:
the tracer's nesting and summary, windowed percentiles and the series
recorder (bitwise, ``nan`` where the reference has ``nan``), JSONL/CSV
exports, Prometheus text (byte-equal), the ``make_obs`` spec surface,
run reports that load across packages, and the engine's ``run_report``
on ``tests/test_obs.py``'s seeded world against the reference's numpy
engine.

Every series channel is bitwise equal except ``forecast``: it is
A_t^T (predicted x total), and A_t comes from the float32 OT plan, which
the parity contract holds to 1e-6 (``tests/test_torch_sinkhorn.py``), so
each slot's forecast is held within 1e-6 x its sum."""
import math

import numpy as np
import pytest
import torch

from _torch_port import (OBS_REGIONS, OBS_SLOTS, obs_world, port_state,
                         port_topology, run_jax_fused)
import repro.obs as ref_obs
import repro.obs.series as ref_series
from repro.core.torta import TortaScheduler as RefTorta
from repro.obs import runtime as ref_rt
from repro.sim import Engine as RefEngine
import repro_torch.obs as obs
import repro_torch.obs.series as series
from repro_torch.core.torta import TortaScheduler
from repro_torch.obs import runtime as obs_rt
from repro_torch.sim.engine import Engine

METRIC_KEYS = ("completed", "dropped", "model_switches", "mean_response_s",
               "mean_wait_s", "mean_work_s", "power_cost_total",
               "switch_cost_total", "operational_overhead", "load_balance",
               "mean_queue_tasks")


def _fake_clock():
    t = [0.0]

    def tick():
        t[0] += 1.0
        return t[0]
    return tick


# ---------------------------------------------------------------- tracer


def _nest(tr):
    with tr.span("outer"):
        with tr.span("inner"):
            pass
        with tr.span("inner"):
            with tr.span("leaf"):
                pass
    with tr.span("outer"):
        pass


def test_tracer_nesting_and_summary_equal_reference():
    got, want = obs.Tracer(clock=_fake_clock()), \
        ref_obs.Tracer(clock=_fake_clock())
    _nest(got)
    _nest(want)
    assert [(r.name, r.depth, r.parent, r.t_start, r.duration_s)
            for r in got.records] == \
        [(r.name, r.depth, r.parent, r.t_start, r.duration_s)
         for r in want.records]
    outer, in1, in2 = got.records[:3]
    assert (outer.depth, in1.depth, in2.depth) == (0, 1, 1)
    assert in1.parent == 0 and in2.parent == 0 and outer.parent == -1
    assert outer.t_start < in1.t_start < in2.t_start
    assert outer.duration_s >= in1.duration_s + in2.duration_s
    assert got.summary() == want.summary()
    rows = {r["name"]: r for r in got.summary()}
    assert rows["inner"]["count"] == 2 and rows["inner"]["depth"] == 1
    assert rows["leaf"]["depth"] == 2
    assert rows["outer"]["mean_s"] == pytest.approx(
        rows["outer"]["total_s"] / 2)
    assert got.summary_table() == want.summary_table()
    assert obs.Tracer().summary_table() == "(no spans recorded)"


def test_traced_decorator():
    tr = obs.Tracer(clock=_fake_clock())

    @tr.traced("work")
    def fn(x):
        return x + 1

    @tr.traced()
    def other():
        return 0

    assert fn(1) == 2 and fn(2) == 3 and other() == 0
    assert [r.name for r in tr.records] == [
        "work", "work", other.__wrapped__.__qualname__]


def test_trace_xla_spans_enter_record_function():
    """``xla=True`` puts each span on a ``torch.profiler`` trace under its
    own name, nested as the spans are."""
    tr = obs.Tracer(xla=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("outer"):
            with tr.span("inner"):
                torch.ones(4).sum()
    names = [e.name for e in prof.events()]
    assert names.count("outer") == 1 and names.count("inner") == 1
    inner = next(e for e in prof.events() if e.name == "inner")
    assert inner.cpu_parent is not None and inner.cpu_parent.name == "outer"
    assert [r.name for r in tr.records] == ["outer", "inner"]
    assert obs.Tracer().xla is False


# ---------------------------------------------------------------- series


def _feed(rec, rng, n_slots, r, forecast_every=0):
    per_slot = []
    for t in range(n_slots):
        n = int(rng.integers(0, 6))
        if t in (2, 3):            # a gap: empty window start behavior
            n = 0
        resp = rng.exponential(20.0, n)
        per_slot.append(resp)
        if forecast_every and t % forecast_every == 0:
            rec.note_forecast(rng.random(r) * 10)
        rec.end_slot(t, responses=resp,
                     queue_tasks=float(rng.integers(0, 50)),
                     arrivals=rng.integers(0, 9, r),
                     drops=int(rng.integers(0, 3)),
                     saturation=rng.random(r),
                     load_balance=float(rng.random()))
    return per_slot


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)     # nan where want has nan


@pytest.mark.parametrize("window", [1, 3, series.DEFAULT_WINDOW])
def test_series_equal_reference(window):
    """The same slots fed to both recorders (forecasts on every other
    slot, a gap of empty slots): every channel bitwise equal, and equal
    to the windowed-percentile oracle of both packages."""
    got_rec = series.SeriesRecorder(4, window=window)
    want_rec = ref_series.SeriesRecorder(4, window=window)
    per_slot = _feed(got_rec, np.random.default_rng(7), 20, 4, 2)
    _feed(want_rec, np.random.default_rng(7), 20, 4, 2)
    got, want = got_rec.timeseries(), want_rec.timeseries()
    assert list(got) == list(want)
    for k in want:
        _same(got[k], want[k])
    oracle = series.windowed_percentiles(per_slot, window=window)
    _same(oracle, ref_series.windowed_percentiles(per_slot, window=window))
    _same(np.stack([got["p50_response_s"], got["p95_response_s"],
                    got["p99_response_s"]], axis=1), oracle)
    assert np.isnan(got["forecast"][1]).all()
    assert np.isnan(got["p50_response_s"]).any() == (window <= 2)


def test_series_exports_round_trip_and_equal_reference(tmp_path):
    rec = series.SeriesRecorder(3, window=4)
    ref = ref_series.SeriesRecorder(3, window=4)
    _feed(rec, np.random.default_rng(11), 6, 3, 3)
    _feed(ref, np.random.default_rng(11), 6, 3, 3)
    ts = rec.timeseries()
    rec.to_jsonl(tmp_path / "port.jsonl")
    ref.to_jsonl(tmp_path / "ref.jsonl")
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "ref.jsonl").read_bytes()
    rows = series.SeriesRecorder.read_jsonl(tmp_path / "port.jsonl")
    assert len(rows) == 6
    for t, row in enumerate(rows):
        assert row["slot"] == int(ts["slot"][t])
        assert row["queue_depth"] == ts["queue_depth"][t]
        assert row["arrivals"] == [float(x) for x in ts["arrivals"][t]]
        p95 = ts["p95_response_s"][t]
        assert (math.isnan(row["p95_response_s"]) if math.isnan(p95)
                else row["p95_response_s"] == p95)
    rec.to_csv(tmp_path / "port.csv")
    ref.to_csv(tmp_path / "ref.csv")
    text = (tmp_path / "port.csv").read_text()
    assert text == (tmp_path / "ref.csv").read_text()
    lines = text.strip().splitlines()
    assert len(lines) == 7                       # header + 6 slots
    assert "arrivals_r0" in lines[0] and "saturation_r2" in lines[0]
    series.SeriesRecorder(2).to_csv(tmp_path / "empty.csv")
    assert (tmp_path / "empty.csv").read_text() == ""


def test_series_exports_are_finite_or_nan():
    rec = series.SeriesRecorder(2)
    rec.note_forecast(np.array([np.inf, 1.0]))
    rec.end_slot(0, responses=np.array([np.inf, 3.0]),
                 queue_tasks=np.inf, arrivals=np.array([1.0, np.inf]),
                 drops=0, saturation=np.array([0.5, -np.inf]),
                 load_balance=np.inf)
    rec.end_slot(1, responses=np.array([1.0, 2.0]), queue_tasks=4.0,
                 arrivals=np.array([2.0, 2.0]), drops=1,
                 saturation=np.array([0.5, 0.5]), load_balance=0.9)
    ts = rec.timeseries()
    for name, arr in ts.items():
        assert not np.isinf(np.asarray(arr, np.float64)).any(), name
    assert ts["queue_depth"][1] == 4.0 and ts["load_balance"][1] == 0.9
    assert series.finite_or_nan(2.5) == 2.5
    assert math.isnan(series.finite_or_nan(np.inf))


# -------------------------------------------------------------- counters


def _increments(c):
    c.inc("micro.retrace.scan", shape="15x256")
    c.inc("micro.retrace.scan", shape="15x512")
    c.inc("micro.retrace.scan", 3, shape="15x256")
    c.inc("engine.tasks.arrived", 1234)
    c.inc("a-b.c d", 2, kind="x", alpha="y")
    c.inc("other")
    return c


def test_prometheus_text_byte_equal_reference():
    got, want = _increments(obs.Counters()), _increments(ref_obs.Counters())
    text = got.prometheus_text()
    assert text == want.prometheus_text()
    assert got.prometheus_text(prefix="x_") == \
        want.prometheus_text(prefix="x_")
    assert "# TYPE repro_micro_retrace_scan counter" in text
    for parse in (obs.parse_prometheus_text, ref_obs.parse_prometheus_text):
        parsed = parse(text)
        assert parsed == ref_obs.parse_prometheus_text(
            want.prometheus_text())
        assert parsed['repro_micro_retrace_scan{shape="15x256"}'] == 4
        assert len(parsed) == len(got.as_dict())
    assert obs.Counters().prometheus_text() == ""


def test_counters_api_equal_reference():
    got, want = _increments(obs.Counters()), _increments(ref_obs.Counters())
    assert got.as_dict() == want.as_dict()
    assert len(got) == len(want) == 5
    assert list(got.names()) == list(want.names())
    for name in want.names():
        assert got.total(name) == want.total(name)
    assert got.total("micro.retrace.scan") == 5
    assert got.get("micro.retrace.scan", shape="15x256") == 4
    assert got.get("missing") == 0


# ------------------------------------------------------- config surface


def _shape_of(o):
    if o is None:
        return None
    return (o.counters is not None, o.tracer is not None,
            o.tracer.xla if o.tracer is not None else None, o.series,
            o.config.window)


SPECS = {
    "None": lambda m: None, "True": lambda m: True, "False": lambda m: False,
    "trace": lambda m: "trace", "trace-xla": lambda m: "trace-xla",
    "ObsConfig": lambda m: m.ObsConfig(counters=False, series=False,
                                       trace=True, window=3),
}


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_make_obs_spec_equal_reference(spec):
    got = obs.make_obs(SPECS[spec](obs))
    assert _shape_of(got) == _shape_of(ref_obs.make_obs(SPECS[spec](ref_obs)))
    if got is not None:
        got.begin_run(3, 45.0)
        assert (got.series is None) == (spec == "ObsConfig")
    shared = obs.Observability()
    assert obs.make_obs(shared) is shared


@pytest.mark.parametrize("spec,error", [("bogus", ValueError),
                                        (3.14, TypeError), ("", ValueError)])
def test_make_obs_errors_equal_reference(spec, error):
    with pytest.raises(error) as got:
        obs.make_obs(spec)
    with pytest.raises(error) as want:
        ref_obs.make_obs(spec)
    assert str(got.value) == str(want.value)


def test_runtime_hooks():
    obs_rt.count("x.y", 3, shape="1")
    assert obs_rt.count_new_shape("x.y", "1") is False
    assert obs_rt.span("nothing") is obs.trace.NULL_SPAN
    obs_rt.record_forecast(np.ones(2))
    o = obs.make_obs("trace")
    o.begin_run(2, 45.0)
    with obs_rt.activate(o):
        assert obs_rt.active() is o
        obs_rt.count("x.y", 3)
        assert obs_rt.count_new_shape("x.z", "8") is True
        assert obs_rt.count_new_shape("x.z", "8") is False
        assert obs_rt.count_new_shape("x.z", "16") is True
        with obs_rt.span("phase"):
            pass
        obs_rt.record_forecast(np.array([1.0, 2.0]))
        with obs_rt.activate(None):
            assert obs_rt.active() is None
            obs_rt.count("x.y")
    assert obs_rt.active() is None
    assert o.counters.get("x.y") == 3 and o.counters.total("x.z") == 2
    assert [r.name for r in o.tracer.records] == ["phase"]
    o.end_slot(0, responses=np.ones(1), queue_tasks=0.0,
               arrivals=np.ones(2), drops=0, saturation=np.ones(2),
               load_balance=1.0)
    np.testing.assert_array_equal(o.timeseries()["forecast"], [[1.0, 2.0]])
    assert o.prometheus_text() == o.counters.prometheus_text()
    off = obs.Observability(obs.ObsConfig(counters=False, series=False))
    assert off.prometheus_text() == "" and off.timeseries() == {}


# ---------------------------------------------------------------- report


def _report(mod):
    rng = np.random.default_rng(3)
    rec = mod.SeriesRecorder(2, window=2)
    _feed(rec, rng, 4, 2, 2)
    return mod.RunReport(
        meta={"n_slots": 4, "scheduler": "TORTA", "nested": {"x": (1, 2)}},
        summary={"completed": 7, "mean_response_s": 1.25,
                 "p95_response_s": float("nan")},
        counters={"engine.tasks.arrived": 9, "micro.shape{shape=2x8}": 1,
                  "micro.shape{shape=2x16}": 2},
        spans=[{"name": "schedule.batch", "count": 4, "total_s": 0.5,
                "mean_s": 0.125, "max_s": 0.2, "depth": 0}],
        series=rec.timeseries())


@pytest.mark.parametrize("writer,reader", [(obs, ref_obs), (ref_obs, obs)],
                         ids=["port-to-reference", "reference-to-port"])
def test_run_report_loads_across_packages(writer, reader, tmp_path):
    rep = _report(writer)
    path = tmp_path / "report.json"
    rep.save(path)
    got = reader.RunReport.load(path)
    assert got.to_json() == rep.to_json()
    assert got.counter("micro.shape") == 3 and got.counter("missing") == 0
    assert got.span_names() == ["schedule.batch"]
    for k, v in rep.series.items():
        np.testing.assert_array_equal(got.series_array(k), v)
    assert math.isnan(got.summary["p95_response_s"])
    assert _report(obs).to_json() == _report(ref_obs).to_json()


def test_environment_info_reports_torch_not_jax():
    info = obs.environment_info()
    assert info["torch"] == torch.__version__
    assert info["torch_cuda"] == torch.version.cuda
    assert "jax" not in info
    ref = ref_obs.environment_info()
    for k in ("python", "platform", "cpu_count", "numpy"):
        assert info[k] == ref[k]
    assert ("card" in info) == torch.cuda.is_available()


def test_environment_info_queries_the_card_once(monkeypatch):
    """Every engine run's report reads the environment; the card's
    ``nvidia-smi`` line is queried once a process, not once a run."""
    import subprocess
    import repro_torch.obs.report as report

    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(
            cmd, 0, stdout="NVIDIA H100 80GB HBM3, 700.00 W\n", stderr="")

    monkeypatch.setattr(report.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(report.torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(report.subprocess, "run", fake_run)
    report._smi_name_power_limit.cache_clear()
    try:
        infos = [obs.environment_info() for _ in range(3)]
        infos.append(obs.Observability(obs.ObsConfig()).report().meta)
    finally:
        report._smi_name_power_limit.cache_clear()
    assert len(calls) == 1
    for info in infos:
        assert info["card_name_power_limit"] == \
            "NVIDIA H100 80GB HBM3, 700.00 W"


# ---------------------------------------------------------------- engine


def _ref_engine(obs_spec, **sched):
    topo, cs, src, _ = obs_world()
    return RefEngine(topo, cs.copy(), src,
                     RefTorta(OBS_REGIONS, seed=0, **sched), seed=4,
                     step_backend="numpy", obs=obs_spec)


def _port_engine(obs_spec, micro_backend="fused", step_backend="torch"):
    topo, cs, _, src = obs_world()
    return Engine(port_topology(topo), port_state(cs), src,
                  TortaScheduler(OBS_REGIONS, seed=0,
                                 micro_backend=micro_backend, device="cpu"),
                  step_backend=step_backend, device="cpu", obs=obs_spec)


def test_engine_run_report_equals_reference():
    """The fused route on the torch step against the reference's numpy
    engine with its Sinkhorn kernel route: equal summary, every series
    channel bitwise (``forecast`` within the float32 plan's 1e-6), every
    counter both packages name equal."""
    ref = _ref_engine(None, use_sinkhorn_kernel=True)
    ref.run(OBS_SLOTS)
    eng = _port_engine(None)
    eng.run(OBS_SLOTS)
    got, want = eng.run_report, ref.run_report
    assert got.summary.keys() == want.summary.keys()
    for k, v in want.summary.items():
        assert got.summary[k] == v or (np.isnan(got.summary[k])
                                       and np.isnan(v)), k
    assert list(got.series) == list(want.series)
    for k, v in want.series.items():
        if k == "forecast":
            assert not np.isnan(got.series[k]).any()
            np.testing.assert_allclose(
                got.series[k], v, rtol=0,
                atol=1e-6 * np.asarray(v).sum(1).max(), err_msg=k)
        else:
            _same(got.series[k], v)
    shared = set(got.counters) & set(want.counters)
    assert {"engine.tasks.arrived", "engine.tasks.assigned",
            "engine.fallback.same_server_conflict"} <= shared
    for k in shared:
        assert got.counters[k] == want.counters[k], k
    assert got.counter("micro.host_sync.scan_all") == OBS_SLOTS
    assert got.counter("micro.shape.scan_all") >= 1
    assert got.counter("engine.host_sync.close_step") == OBS_SLOTS
    assert got.spans == []
    meta = {k: got.meta[k] for k in ("n_slots", "n_regions", "n_servers",
                                     "scheduler", "slot_seconds")}
    assert meta == {k: want.meta[k] for k in meta}
    assert got.meta["step_backend"] == "torch"
    assert got.meta["torch"] == torch.__version__
    np.testing.assert_array_equal(np.stack(eng.arrivals_hist),
                                  np.stack(ref.arrivals_hist))
    assert len(eng.arrivals_hist) == OBS_SLOTS


@pytest.mark.parametrize("step_backend", ["torch", "numpy"])
def test_obs_is_observation_only(step_backend):
    """Summaries bitwise equal with observability off, at the default
    tier and traced; off leaves no report and empty counters."""
    runs = {}
    for spec in (False, None, "trace", "trace-xla"):
        eng = _port_engine(spec, step_backend=step_backend)
        runs[spec] = eng.run(6).summary()
        if spec is False:
            assert eng.obs is None and eng.run_report is None
            assert len(eng.counters) == 0
        else:
            assert eng.run_report.meta["step_backend"] == step_backend
            assert eng.counters is eng.obs.counters
            assert eng.counters.get("engine.tasks.arrived") > 0
    for k in METRIC_KEYS:
        assert runs[False][k] == runs[None][k] == runs["trace"][k] \
            == runs["trace-xla"][k], k


def test_run_obs_override_and_report_round_trip(tmp_path):
    eng = _port_engine(False)
    eng.run(3, obs="trace")
    rep = eng.run_report
    assert rep is not None and "engine.apply" in rep.span_names()
    rep.save(tmp_path / "r.json")
    back = ref_obs.RunReport.load(tmp_path / "r.json")
    assert back.counters == rep.counters and back.meta["n_slots"] == 3
    parsed = obs.parse_prometheus_text(eng.obs.prometheus_text())
    assert parsed["repro_engine_tasks_arrived"] == \
        rep.counter("engine.tasks.arrived")
    eng.run(3, obs=False)
    assert eng.obs is None


def _span_counts(report):
    return {row["name"]: row["count"] for row in report.spans}


@pytest.mark.parametrize("route", ["fused", "numpy"])
def test_traced_span_names_equal_reference(route, tmp_path):
    """A traced run names the reference's spans, each as often: the fused
    route against the JAX package's fused path (jitted engine step, in a
    subprocess), the numpy route against its numpy path in process."""
    eng = _port_engine("trace", micro_backend=route)
    eng.run(OBS_SLOTS)
    got = _span_counts(eng.run_report)
    if route == "fused":
        ref = run_jax_fused(tmp_path, "spans")
        want = dict(zip(ref["names"].tolist(), ref["counts"].tolist()))
        assert got["micro.host_sync"] == OBS_SLOTS
    else:
        ref = _ref_engine("trace")
        ref.run(OBS_SLOTS)
        want = _span_counts(ref.run_report)
        assert "micro.host_sync" not in got
    assert got == want
    for name in ("schedule.batch", "macro.phase1", "engine.apply",
                 "engine.slot_close"):
        assert got[name] == OBS_SLOTS, name
    records = eng.obs.tracer.records
    assert [r.t_start for r in records] == sorted(r.t_start
                                                  for r in records)
    assert all(r.duration_s >= 0 for r in records)
