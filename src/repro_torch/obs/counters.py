"""Named monotonic counters with optional labels (port of
``repro/obs/counters.py``).

The registry makes the engine's invisible events countable: new operand
shapes of the greedy, numpy-fallback activations of the engine's apply,
``BatchDecision`` host syncs, buffered/dropped/resolve-failed task rows.
Counters only ever go up within a run (Prometheus ``counter``
semantics); :meth:`Counters.prometheus_text` renders the text exposition
format, byte for byte as the reference does for the same increments.

A counter key is ``(name, labels)`` where ``labels`` is a sorted tuple of
``(key, value)`` string pairs; the flattened ``name{k=v}`` form is used
wherever counters are serialized (reports, JSON, Prometheus).
"""
from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

LabelKey = Tuple[str, Tuple[Tuple[str, str], ...]]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


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

    def __len__(self) -> int:
        return len(self._cells)

    def inc(self, name: str, n: int = 1, **labels) -> int:
        """Add ``n`` to the counter cell; returns the new value."""
        key = (name, _labelize(labels))
        value = self._cells.get(key, 0) + int(n)
        self._cells[key] = value
        return value

    def get(self, name: str, **labels) -> int:
        return self._cells.get((name, _labelize(labels)), 0)

    def total(self, name: str) -> int:
        """Sum over every label set of ``name``."""
        return sum(v for (n, _), v in self._cells.items() if n == name)

    def names(self) -> Iterator[str]:
        return iter(sorted({n for n, _ in self._cells}))

    def as_dict(self) -> Dict[str, int]:
        """Flattened ``name{k=v}`` -> value mapping (sorted, stable)."""
        return {flatten_key(n, labels): v
                for (n, labels), v in sorted(self._cells.items())}

    def prometheus_text(self, prefix: str = "repro_") -> str:
        """Prometheus text exposition format.  Counter names are
        sanitized (``.`` -> ``_``) and prefixed; labels pass through."""
        lines = []
        by_name: Dict[str, list] = {}
        for (name, labels), value in sorted(self._cells.items()):
            by_name.setdefault(name, []).append((labels, value))
        for name, cells in by_name.items():
            metric = prefix + _NAME_RE.sub("_", name.replace(".", "_"))
            lines.append(f"# TYPE {metric} counter")
            for labels, value in cells:
                if labels:
                    inner = ",".join(f'{k}="{v}"' for k, v in labels)
                    lines.append(f"{metric}{{{inner}}} {value}")
                else:
                    lines.append(f"{metric} {value}")
        return "\n".join(lines) + ("\n" if lines else "")


def parse_prometheus_text(text: str) -> Dict[str, int]:
    """Parse the output of :meth:`Counters.prometheus_text` back into a
    ``metric{labels}`` -> value dict (a round-trip guard, not a general
    Prometheus parser)."""
    out: Dict[str, int] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        key, _, value = line.rpartition(" ")
        out[key] = int(float(value))
    return out
