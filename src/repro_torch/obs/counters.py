"""Named monotonic counters with optional labels (port of the counters
tier of ``repro/obs/counters.py``).

A counter key is ``(name, labels)`` where ``labels`` is a sorted tuple of
``(key, value)`` string pairs; the flattened ``name{k=v}`` form is used
wherever counters are serialized.
"""
from __future__ import annotations

from typing import Dict, Tuple

LabelKey = Tuple[str, Tuple[Tuple[str, str], ...]]


def _labelize(labels: Dict[str, object]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def flatten_key(name: str, labels: Tuple[Tuple[str, str], ...]) -> str:
    """``name{k=v,...}`` — the serialized counter id."""
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class Counters:
    """A per-run registry of named monotonic counters."""

    def __init__(self):
        self._cells: Dict[LabelKey, int] = {}

    def inc(self, name: str, n: int = 1, **labels) -> int:
        """Add ``n`` to the counter cell; returns the new value."""
        key = (name, _labelize(labels))
        value = self._cells.get(key, 0) + int(n)
        self._cells[key] = value
        return value

    def get(self, name: str, **labels) -> int:
        return self._cells.get((name, _labelize(labels)), 0)

    def as_dict(self) -> Dict[str, int]:
        """Flattened ``name{k=v}`` -> value mapping (sorted, stable)."""
        return {flatten_key(n, labels): v
                for (n, labels), v in sorted(self._cells.items())}
