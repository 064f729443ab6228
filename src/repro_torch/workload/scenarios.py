"""Scenario library: named demand regimes behind a registry (port of
``repro/workload/scenarios.py``, the same draws in the same order).

Every scenario is a factory ``fn(n_slots, n_regions, seed=0, *,
base_rate=..., **kw) -> StreamingWorkload`` registered under a name:

* ``diurnal``         — the historical single-day region-phased sine
                        (exactly ``legacy.generate_traffic``);
* ``multiday``        — several diurnal days with weekday/weekend
                        modulation (SageServe-style multi-day horizons);
* ``flash_crowd``     — MMPP-style heavy-tailed bursts on top of a calm
                        diurnal floor (paper Fig 2's surge regime);
* ``regional_outage`` — one region's demand fails over to the others
                        mid-run, then returns (per-slot totals conserved);
* ``trace_replay``    — replay a (T, R) arrival CSV/JSON trace with
                        optional model-mix resampling.

``get_scenario(name)`` returns the factory; ``make_source`` is the
one-call convenience.  Registration is open: downstream code can add
regimes with ``@register_scenario("name")``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.workload.batch import zipf_model_mix
from repro_torch.workload.legacy import generate_traffic
from repro_torch.workload.stream import StreamingWorkload
from repro_torch.workload.trace import DEFAULT_TRACE, load_trace, resample_trace

ScenarioFn = Callable[..., StreamingWorkload]

_REGISTRY: Dict[str, ScenarioFn] = {}


def register_scenario(name: str):
    def deco(fn: ScenarioFn) -> ScenarioFn:
        if name in _REGISTRY:
            raise ValueError(f"scenario {name!r} already registered")
        _REGISTRY[name] = fn
        return fn
    return deco


def get_scenario(name: str) -> ScenarioFn:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; registered: "
                       f"{', '.join(list_scenarios())}") from None


def list_scenarios() -> tuple:
    return tuple(sorted(_REGISTRY))


def make_source(name: str, n_slots: int, n_regions: int, seed: int = 0,
                **kw) -> StreamingWorkload:
    return get_scenario(name)(n_slots, n_regions, seed, **kw)


def _noisy(traffic: np.ndarray, noise: float,
           rng: np.random.Generator) -> np.ndarray:
    """Multiplicative Gaussian modulation with the same 0.05 floor as
    ``legacy.generate_traffic`` (never flips demand negative)."""
    return traffic * np.maximum(
        1.0 + noise * rng.standard_normal(traffic.shape), 0.05)


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------


@register_scenario("diurnal")
def diurnal(n_slots: int, n_regions: int, seed: int = 0, *,
            base_rate: float = 6.0, **traffic_kw) -> StreamingWorkload:
    """The historical default: one region-phased diurnal day + surges."""
    traffic = generate_traffic(n_slots, n_regions, seed,
                               base_rate=base_rate, **traffic_kw)
    return StreamingWorkload(traffic, seed=seed, name="diurnal")


# weekday gain profile, Mon..Sun; weekends sit well below office-hour load
_WEEKDAY_GAIN = np.array([1.00, 1.06, 1.10, 1.08, 1.02, 0.55, 0.50])


@register_scenario("multiday")
def multiday(n_slots: int, n_regions: int, seed: int = 0, *,
             base_rate: float = 6.0, days: Optional[int] = None,
             diurnal_amp: float = 0.6, noise: float = 0.15,
             start_weekday: int = 0,
             weekend_level: Optional[float] = None) -> StreamingWorkload:
    """Several diurnal days with weekday/weekend modulation."""
    rng = np.random.default_rng(seed)
    days = int(days) if days else max(2, n_slots // 96)
    spd = n_slots / days                        # slots per simulated day
    t = np.arange(n_slots, dtype=np.float64)
    phase = rng.uniform(0, 2 * np.pi, n_regions)[None, :]
    weight = rng.dirichlet(np.ones(n_regions) * 2.0) * n_regions
    wave = 1.0 + diurnal_amp * np.sin(
        2 * np.pi * t[:, None] / spd + phase)
    gain = _WEEKDAY_GAIN.copy()
    if weekend_level is not None:
        gain[5:] = [weekend_level, weekend_level * 0.9]
    weekday = (start_weekday + (t // spd).astype(np.int64)) % 7
    traffic = base_rate * weight[None, :] * wave * gain[weekday][:, None]
    traffic = np.maximum(_noisy(traffic, noise, rng), 0.1)
    return StreamingWorkload(traffic, seed=seed, name="multiday")


@register_scenario("flash_crowd")
def flash_crowd(n_slots: int, n_regions: int, seed: int = 0, *,
                base_rate: float = 6.0, burst_rate: float = 0.05,
                pareto_alpha: float = 1.3, burst_scale_cap: float = 20.0,
                mean_duration_slots: float = 4.0,
                spillover: float = 0.3, **traffic_kw) -> StreamingWorkload:
    """MMPP-style flash crowds: burst starts arrive as a Bernoulli process
    (rate ``burst_rate`` per slot), each with a heavy-tailed (Pareto)
    intensity, a geometric duration, a triangular rise/decay envelope, and
    partial spillover onto the two neighboring regions."""
    traffic_kw.setdefault("diurnal_amp", 0.4)
    traffic = generate_traffic(n_slots, n_regions, seed,
                               base_rate=base_rate, surges=0, **traffic_kw)
    rng = np.random.default_rng(seed + 202)
    boost = np.zeros_like(traffic)
    for s0 in np.flatnonzero(rng.random(n_slots) < burst_rate):
        reg = int(rng.integers(n_regions))
        scale = float(min(1.0 + rng.pareto(pareto_alpha) * 3.0,
                          burst_scale_cap))
        dur = 1 + int(rng.geometric(1.0 / max(mean_duration_slots, 1.0)))
        span = np.arange(s0, min(s0 + dur, n_slots))
        # sharp rise, linear decay — the reactive-scheduler killer shape
        env = 1.0 - (span - s0) / max(dur, 1)
        boost[span, reg] += (scale - 1.0) * env
        # set difference: with 2 regions both neighbors are the same
        # region and must only receive the spillover once
        for nb in {(reg - 1) % n_regions, (reg + 1) % n_regions} - {reg}:
            boost[span, nb] += spillover * (scale - 1.0) * env
    return StreamingWorkload(traffic * (1.0 + boost), seed=seed,
                             name="flash_crowd")


@register_scenario("regional_outage")
def regional_outage(n_slots: int, n_regions: int, seed: int = 0, *,
                    base_rate: float = 6.0,
                    outage_region: Optional[int] = None,
                    outage_start_frac: float = 0.4,
                    outage_duration_frac: float = 0.25,
                    ramp_slots: int = 3, **traffic_kw) -> StreamingWorkload:
    """A region's demand fails over to the others mid-run: during the
    outage window its arrivals are redistributed to the surviving regions
    (weighted by their baseline share) with a short ramp, then return.
    Per-slot total demand is conserved — users retry elsewhere."""
    if n_regions < 2:
        raise ValueError("regional_outage needs >= 2 regions")
    traffic = generate_traffic(n_slots, n_regions, seed,
                               base_rate=base_rate, **traffic_kw)
    rng = np.random.default_rng(seed + 101)
    ro = int(rng.integers(n_regions)) if outage_region is None \
        else int(outage_region)
    s0 = int(outage_start_frac * n_slots)
    s1 = min(s0 + max(int(outage_duration_frac * n_slots), 1), n_slots)
    w = traffic.mean(axis=0).copy()
    w[ro] = 0.0
    w = w / max(w.sum(), 1e-12)
    out = traffic.copy()
    for s in range(s0, s1):
        frac = min(1.0, (s - s0 + 1) / max(ramp_slots, 1))
        moved = traffic[s, ro] * frac
        out[s, ro] -= moved
        out[s] += w * moved
    return StreamingWorkload(out, seed=seed, name="regional_outage")


@register_scenario("trace_replay")
def trace_replay(n_slots: int, n_regions: int, seed: int = 0, *,
                 path=None, base_rate: Optional[float] = None,
                 model_mix=None, resample_mix: bool = False,
                 **_ignored) -> StreamingWorkload:
    """Replay a (T, R) arrival trace (CSV/JSON, e.g. Azure-LLM-style),
    resampled onto the requested grid.  ``base_rate`` rescales the trace
    so its mean per-region rate matches the harness calibration; the
    model mix comes from trace metadata, the ``model_mix`` argument, or a
    seeded Dirichlet resample of the catalog zipf when
    ``resample_mix=True``."""
    arr, meta = load_trace(path or DEFAULT_TRACE)
    traffic = resample_trace(arr, n_slots, n_regions)
    if base_rate is not None:
        traffic = traffic * (base_rate / max(traffic.mean(), 1e-12))
    mix = model_mix if model_mix is not None else meta.get("model_mix")
    if mix is None and resample_mix:
        mix = np.random.default_rng(seed + 303).dirichlet(
            zipf_model_mix() * 20.0)
    return StreamingWorkload(np.maximum(traffic, 1e-3), seed=seed,
                             model_mix=None if mix is None
                             else np.asarray(mix, np.float64),
                             name="trace_replay")
