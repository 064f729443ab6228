"""Per-slot time series with windowed tail percentiles (port of
``repro/obs/series.py``).

:class:`SeriesRecorder` keeps one row per slot: windowed p50/p95/p99
response, queue depth, per-region saturation ``active/total``, drop
rate, arrivals vs. the scheduler's forecast.  A flash-crowd tail spike or
a regional-outage recovery curve is invisible in a single end-of-run
scalar; these series show it.

Response percentiles are *windowed*: each slot's value is the percentile
over the completions of the last ``window`` slots (a ring of per-slot
response arrays — O(window) memory, one ``np.percentile`` per slot).
Slots whose window holds no completions report ``nan``, never a fake
0.0.

numpy on the host, as in the reference: every input it reads is already
a host array in the engine.  The recorder is observation-only: it reads
values the engine already computed and never touches engine state, so
enabling it changes no metric bitwise.
"""
from __future__ import annotations

import collections
import csv
import json
from typing import Deque, Dict, List, Optional

import numpy as np

DEFAULT_WINDOW = 16
PERCENTILES = (50, 95, 99)


def finite_or_nan(x):
    """Exported-value guard: ±inf (a divide-by-zero or overflow artifact
    upstream) becomes nan, so every exported series/summary value is
    either finite or an explicit "no data" nan — never an infinity that
    JSON serializes as ``Infinity`` and plots/aggregations silently eat.
    Finite values pass through bitwise untouched."""
    arr = np.asarray(x, np.float64)
    if np.isinf(arr).any():
        arr = np.where(np.isinf(arr), np.nan, arr)
        return arr if arr.ndim else float(arr)
    return x


def windowed_percentiles(per_slot_values: List[np.ndarray],
                         window: int = DEFAULT_WINDOW,
                         percentiles=PERCENTILES) -> np.ndarray:
    """Reference oracle: ``(n_slots, len(percentiles))`` percentile
    series where row ``t`` is computed over the concatenation of
    ``per_slot_values[max(0, t-window+1) : t+1]`` (nan when empty).
    ``SeriesRecorder`` computes exactly this incrementally."""
    out = np.full((len(per_slot_values), len(percentiles)), np.nan)
    for t in range(len(per_slot_values)):
        chunk = per_slot_values[max(0, t - window + 1):t + 1]
        flat = np.concatenate([np.asarray(c, np.float64) for c in chunk]) \
            if chunk else np.zeros(0)
        if flat.size:
            out[t] = np.percentile(flat, percentiles)
    return out


class SeriesRecorder:
    """Ring-buffered per-slot series for one engine run."""

    def __init__(self, n_regions: int, *, window: int = DEFAULT_WINDOW,
                 slot_seconds: float = 45.0):
        self.n_regions = n_regions
        self.window = max(int(window), 1)
        self.slot_seconds = slot_seconds
        self._window_responses: Deque[np.ndarray] = collections.deque(
            maxlen=self.window)
        self.slots: List[int] = []
        # scalar channels (one float per slot)
        self.p50_response_s: List[float] = []
        self.p95_response_s: List[float] = []
        self.p99_response_s: List[float] = []
        self.queue_depth: List[float] = []
        self.completions: List[int] = []
        self.drops: List[int] = []
        self.drop_rate: List[float] = []
        self.load_balance: List[float] = []
        # (R,) channels (one row per slot)
        self.arrivals: List[np.ndarray] = []
        self.forecast: List[np.ndarray] = []
        self.saturation: List[np.ndarray] = []
        self._pending_forecast: Optional[np.ndarray] = None

    # ------------------------------------------------------------------

    def note_forecast(self, pred_inbound: np.ndarray) -> None:
        """Called by the scheduler mid-slot (TORTA's expected inbound
        tasks per region under A_t); picked up at ``end_slot``."""
        self._pending_forecast = np.asarray(pred_inbound,
                                            np.float64).copy()

    def end_slot(self, t: int, *, responses: np.ndarray,
                 queue_tasks: float, arrivals: np.ndarray,
                 drops: int, saturation: np.ndarray,
                 load_balance: float) -> None:
        """Record one slot.  ``responses`` is THIS slot's completion
        response times; ``saturation`` is the per-region active/total
        server fraction at slot close."""
        responses = np.asarray(finite_or_nan(
            np.asarray(responses, np.float64)), np.float64)
        self._window_responses.append(responses)
        flat = (np.concatenate(self._window_responses)
                if self._window_responses else np.zeros(0))
        if flat.size:
            p50, p95, p99 = np.percentile(flat, PERCENTILES)
        else:
            p50 = p95 = p99 = float("nan")
        self.slots.append(int(t))
        self.p50_response_s.append(float(p50))
        self.p95_response_s.append(float(p95))
        self.p99_response_s.append(float(p99))
        self.queue_depth.append(float(queue_tasks))
        self.completions.append(int(responses.size))
        self.drops.append(int(drops))
        arrivals = np.asarray(arrivals, np.float64)
        self.drop_rate.append(
            float(drops) / max(float(arrivals.sum()), 1.0))
        self.load_balance.append(float(load_balance))
        self.arrivals.append(arrivals.copy())
        fc = self._pending_forecast
        self.forecast.append(fc if fc is not None
                             else np.full(self.n_regions, np.nan))
        self._pending_forecast = None
        self.saturation.append(np.asarray(saturation, np.float64).copy())

    # ------------------------------------------------------------------

    @property
    def n_slots(self) -> int:
        return len(self.slots)

    def timeseries(self) -> Dict[str, np.ndarray]:
        """All channels as arrays: scalar channels ``(T,)``, regional
        channels ``(T, R)``.  Float channels are finite-or-nan (the
        export contract: no infinities ever leave the recorder)."""
        def stack(rows):
            return (np.stack(rows) if rows
                    else np.zeros((0, self.n_regions)))

        def guard(x):
            return np.asarray(finite_or_nan(np.asarray(x, np.float64)),
                              np.float64)

        return {
            "slot": np.asarray(self.slots, np.int64),
            "p50_response_s": guard(self.p50_response_s),
            "p95_response_s": guard(self.p95_response_s),
            "p99_response_s": guard(self.p99_response_s),
            "queue_depth": guard(self.queue_depth),
            "completions": np.asarray(self.completions, np.int64),
            "drops": np.asarray(self.drops, np.int64),
            "drop_rate": guard(self.drop_rate),
            "load_balance": guard(self.load_balance),
            "arrivals": guard(stack(self.arrivals)),
            "forecast": guard(stack(self.forecast)),
            "saturation": guard(stack(self.saturation)),
        }

    # ------------------------------------------------------------ export

    def _rows(self):
        ts = self.timeseries()
        scalar = [k for k, v in ts.items() if v.ndim == 1]
        regional = [k for k, v in ts.items() if v.ndim == 2]
        for i in range(self.n_slots):
            row = {k: ts[k][i].item() for k in scalar}
            for k in regional:
                row[k] = [float(x) for x in ts[k][i]]
            yield row

    def to_jsonl(self, path) -> None:
        """One JSON object per slot (regional channels as lists)."""
        with open(path, "w") as fh:
            for row in self._rows():
                fh.write(json.dumps(row, default=float) + "\n")

    @staticmethod
    def read_jsonl(path) -> List[Dict]:
        with open(path) as fh:
            return [json.loads(line) for line in fh if line.strip()]

    def to_csv(self, path) -> None:
        """Flat CSV: regional channels expand to ``name_r<j>`` columns."""
        rows = list(self._rows())
        if not rows:
            open(path, "w").close()
            return
        header: List[str] = []
        for k, v in rows[0].items():
            if isinstance(v, list):
                header.extend(f"{k}_r{j}" for j in range(len(v)))
            else:
                header.append(k)
        with open(path, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(header)
            for row in rows:
                flat: List = []
                for v in row.values():
                    flat.extend(v if isinstance(v, list) else [v])
                w.writerow(flat)
