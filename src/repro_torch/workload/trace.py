"""Arrival-trace loading and resampling for ``trace_replay`` (port of
``repro/workload/trace.py``; the example trace is this package's own copy,
byte for byte).

Traces are (T, R) expected/observed arrival matrices, in the spirit of the
Azure-LLM-inference public traces: one row per interval, one column per
region (or cluster).  Two on-disk formats:

* **CSV** — optional header; if the first column is named ``slot`` (or
  ``t``/``time``) it is dropped, every remaining column is a region.
* **JSON** — ``{"arrivals": [[...], ...]}`` plus optional metadata keys
  (``interval_s``, ``model_mix`` over the served-model catalogue, ...).

``resample_trace`` maps an arbitrary (T0, R0) trace onto the requested
(T, R) grid: time is linearly interpolated (preserving per-slot rates),
surplus trace regions are folded (summed) round-robin, and missing
regions are filled by splitting a trace column evenly — so region
reshaping preserves each slot's total arrival rate exactly.
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, Tuple, Union

import numpy as np

DEFAULT_TRACE = pathlib.Path(__file__).resolve().parent / "data" \
    / "example_trace.json"

_INDEX_COLUMNS = ("slot", "t", "time", "interval")


def load_trace(path: Union[str, pathlib.Path]
               ) -> Tuple[np.ndarray, Dict]:
    """Read a trace file; returns ((T, R) float array, metadata dict)."""
    path = pathlib.Path(path)
    if path.suffix.lower() == ".json":
        obj = json.loads(path.read_text())
        arr = np.asarray(obj.pop("arrivals"), np.float64)
        meta = dict(obj)
    else:
        text = path.read_text().strip().splitlines()
        first = text[0].split(",")
        drop_index = False
        header = any(not _is_number(tok) for tok in first)
        if header:
            drop_index = first[0].strip().lower() in _INDEX_COLUMNS
            text = text[1:]
        arr = np.asarray([[float(x) for x in line.split(",")]
                          for line in text if line.strip()], np.float64)
        if drop_index:
            arr = arr[:, 1:]
        meta = {}
    if arr.ndim != 2 or arr.shape[0] < 2 or arr.shape[1] < 1:
        raise ValueError(f"trace {path} must be (T>=2, R>=1), "
                         f"got shape {arr.shape}")
    if np.any(arr < 0):
        raise ValueError(f"trace {path} contains negative arrivals")
    return arr, meta


def _is_number(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def resample_trace(arr: np.ndarray, n_slots: int,
                   n_regions: int) -> np.ndarray:
    """Map a (T0, R0) trace onto (n_slots, n_regions)."""
    arr = np.asarray(arr, np.float64)
    t0, r0 = arr.shape
    if t0 != n_slots:
        xp = np.linspace(0.0, 1.0, t0)
        x = np.linspace(0.0, 1.0, n_slots)
        arr = np.stack([np.interp(x, xp, arr[:, j]) for j in range(r0)],
                       axis=1)
    if r0 == n_regions:
        return arr
    if r0 > n_regions:
        out = np.zeros((arr.shape[0], n_regions))
        for j in range(r0):
            out[:, j % n_regions] += arr[:, j]
        return out
    # r0 < n_regions: split each trace column evenly over the regions
    # that map to it (j -> j % r0)
    share = np.bincount(np.arange(n_regions) % r0, minlength=r0)
    out = np.stack([arr[:, j % r0] / share[j % r0]
                    for j in range(n_regions)], axis=1)
    return out
