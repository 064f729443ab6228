"""RunReport — the JSON artifact one engine run emits (port of
``repro/obs/report.py``; a report saved by either package loads in the
other).

Bundles the run's summary metrics, counters, span table and per-slot
series into a single serializable object so benchmarks, examples and
tests can persist and compare runs without re-deriving anything from
live engine state.  ``environment_info`` captures the execution
substrate.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import platform
import subprocess
from typing import Any, Dict, List

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _smi_name_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of card 0, as
    ``--query-gpu=name,power.limit --format=csv,noheader`` gives them;
    what went wrong, in parentheses, where it cannot be read.  Read once a
    process: every engine run's report asks, and a process spawn inside
    the run's timed window would be charged to its slots."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return f"unavailable ({type(exc).__name__})"
    lines = out.strip().splitlines()
    return lines[0] if lines else "unavailable (no output)"


def environment_info() -> Dict[str, Any]:
    """Substrate facts that make perf numbers comparable across machines:
    the reference's, with torch and its CUDA version in jax's place, and,
    where a card is present, its name and power limit.  Reports facts
    only: it chooses no device and raises nothing without a card."""
    info: Dict[str, Any] = {
        "python": platform.python_version(),
        "platform": platform.platform(),
        "cpu_count": os.cpu_count(),
        "numpy": np.__version__,
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
    }
    if torch.cuda.is_available():
        info["card"] = torch.cuda.get_device_name(0)
        info["card_name_power_limit"] = _smi_name_power_limit()
    return info


def _jsonable(value):
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, (np.integer,)):
        return int(value)
    if isinstance(value, (np.floating,)):
        return float(value)
    if isinstance(value, dict):
        return {k: _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    return value


@dataclasses.dataclass
class RunReport:
    """One run's observability artifact."""

    meta: Dict[str, Any]                 # run config + environment
    summary: Dict[str, float]            # MetricsAggregator.summary()
    counters: Dict[str, int]             # flattened name{labels} -> value
    spans: List[Dict]                    # Tracer.summary() rows
    series: Dict[str, Any]               # SeriesRecorder.timeseries()

    # ------------------------------------------------------------------

    def counter(self, name: str) -> int:
        """Sum over every label set of ``name`` (0 if absent)."""
        total = 0
        for key, value in self.counters.items():
            if key == name or key.startswith(name + "{"):
                total += value
        return total

    def span_names(self) -> List[str]:
        return [row["name"] for row in self.spans]

    def series_array(self, channel: str) -> np.ndarray:
        return np.asarray(self.series[channel])

    # ------------------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {
            "meta": _jsonable(self.meta),
            "summary": _jsonable(self.summary),
            "counters": _jsonable(self.counters),
            "spans": _jsonable(self.spans),
            "series": _jsonable(self.series),
        }

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, default=float)

    def save(self, path) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_json())

    @classmethod
    def from_json(cls, text: str) -> "RunReport":
        d = json.loads(text)
        return cls(meta=d["meta"], summary=d["summary"],
                   counters=d["counters"], spans=d["spans"],
                   series=d["series"])

    @classmethod
    def load(cls, path) -> "RunReport":
        with open(path) as fh:
            return cls.from_json(fh.read())
