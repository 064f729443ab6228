"""Engine observability: per-slot time series, phase tracing, counters
(port of ``repro/obs``).

Windowed per-slot percentile series (``series.py``), host-side span
timers over the slot's phases (``trace.py``) and a monotonic-counter
registry for the otherwise-invisible events (``counters.py``).  One run
emits one :class:`RunReport` (JSON, loadable by either package), and
counters export in Prometheus text format.

Overhead policy, as in the reference: counters + series are cheap (dict
increments and one windowed ``np.percentile`` per slot) and default-on
in the engine; span tracing costs two clock reads per phase and is
opt-in (``ObsConfig(trace=True)`` / ``Engine(..., obs="trace")``).  The
layer is observation-only — enabling it changes no engine metric
bitwise.

Counter names are the reference's, with one exception: the reference
counts each new operand shape of its jitted greedy as a retrace
(``micro.retrace.scan_all``, ``micro.retrace.scan``); the port has no
jit and counts the same first sightings as ``micro.shape.scan_all`` and
``micro.shape.scan``.  The reference's ``engine.retrace.*`` (its jitted
engine step) and ``*.sanitize.*`` (its checked variants) have no
counterpart.

Usage::

    eng = Engine(topo, state, wl, sched)            # default-on obs
    eng.run(obs="trace")                            # opt-in span timing
    report = eng.run_report                         # RunReport
    report.series["p95_response_s"]                 # per-slot series
    eng.obs.counters.as_dict()                      # raw counters
    print(eng.obs.tracer.summary_table())           # span table
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch.obs.counters import Counters, parse_prometheus_text
from repro_torch.obs.report import RunReport, environment_info
from repro_torch.obs.series import (DEFAULT_WINDOW, SeriesRecorder,
                                    windowed_percentiles)
from repro_torch.obs.trace import Tracer

__all__ = [
    "Counters", "ObsConfig", "Observability", "RunReport",
    "SeriesRecorder", "Tracer", "environment_info", "make_obs",
    "parse_prometheus_text", "windowed_percentiles",
]


@dataclasses.dataclass
class ObsConfig:
    """What to collect.  The default is the default-on cheap tier."""

    counters: bool = True        # monotonic event counters
    series: bool = True          # per-slot time series
    trace: bool = False          # host-side span timers (opt-in)
    # each span also a torch.profiler.record_function scope (the
    # reference's name: there a jax.profiler annotation)
    trace_xla: bool = False
    window: int = DEFAULT_WINDOW  # percentile window, in slots


class Observability:
    """One run's collection state: counters + tracer + series.

    The engine owns an instance, activates it for the dynamic extent of
    ``run()`` (see ``obs/runtime.py``) and feeds the series recorder
    once per slot; everything else reaches it through the runtime
    hooks."""

    def __init__(self, config: Optional[ObsConfig] = None):
        self.config = config or ObsConfig()
        self.counters = Counters() if self.config.counters else None
        self.tracer = (Tracer(xla=self.config.trace_xla)
                       if self.config.trace else None)
        self.series: Optional[SeriesRecorder] = None

    # ------------------------------------------------------------------

    def begin_run(self, n_regions: int, slot_seconds: float) -> None:
        """Bind the series recorder to the run's fleet shape.  Repeated
        ``run()`` calls on one engine restart the series (counters and
        spans accumulate monotonically across runs)."""
        if self.config.series:
            self.series = SeriesRecorder(
                n_regions, window=self.config.window,
                slot_seconds=slot_seconds)

    def end_slot(self, t: int, **channels) -> None:
        if self.series is not None:
            self.series.end_slot(t, **channels)

    # ------------------------------------------------------------------

    def timeseries(self) -> Dict[str, Any]:
        """Per-slot series arrays (empty dict when series are off)."""
        return self.series.timeseries() if self.series is not None else {}

    def prometheus_text(self) -> str:
        return (self.counters.prometheus_text()
                if self.counters is not None else "")

    def report(self, *, summary: Optional[Dict[str, float]] = None,
               meta: Optional[Dict[str, Any]] = None) -> RunReport:
        full_meta = dict(environment_info())
        if meta:
            full_meta.update(meta)
        return RunReport(
            meta=full_meta,
            summary=dict(summary or {}),
            counters=(self.counters.as_dict()
                      if self.counters is not None else {}),
            spans=(self.tracer.summary()
                   if self.tracer is not None else []),
            series=self.timeseries())


def make_obs(spec) -> Optional[Observability]:
    """Normalize the ``obs=`` argument surface:

    * ``None`` / ``True``   -> default-on cheap tier (counters + series)
    * ``False``             -> observability fully off
    * ``"trace"``           -> default tier + span tracing
    * ``"trace-xla"``       -> tracing, each span also a
      ``torch.profiler.record_function`` scope
    * ``ObsConfig``         -> as configured
    * ``Observability``     -> used as-is (shared across runs)
    """
    if spec is False:
        return None
    if spec is None or spec is True:
        return Observability()
    if isinstance(spec, Observability):
        return spec
    if isinstance(spec, ObsConfig):
        return Observability(spec)
    if isinstance(spec, str):
        if spec == "trace":
            return Observability(ObsConfig(trace=True))
        if spec == "trace-xla":
            return Observability(ObsConfig(trace=True, trace_xla=True))
        raise ValueError(f"unknown obs spec: {spec!r} "
                         "(expected 'trace' or 'trace-xla')")
    raise TypeError(f"obs must be None/bool/str/ObsConfig/Observability, "
                    f"got {type(spec).__name__}")
