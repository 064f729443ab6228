"""The hot-path hook surface: a process-global active ``Observability``
(port of ``repro/obs/runtime.py``).

Threading an obs object through every function signature of the slot
(engine -> scheduler -> micro layer -> kernel wrappers) would
contaminate APIs that exist for numerical work; instead ``Engine.run``
*activates* its obs for the duration of the run and the instrumented
call sites reach it through these module functions.  Every hook is a
near-no-op when nothing is active (one global load + ``is None`` test).

The activation is a stack (re-entrant): an engine run nested inside an
instrumented run records into its own obs (or nothing).
"""
from __future__ import annotations

import contextlib

from repro_torch.obs.trace import NULL_SPAN

_ACTIVE = None            # the innermost activated Observability (or None)
_STACK = []


def active():
    """The currently-activated ``Observability`` (None outside a run)."""
    return _ACTIVE


@contextlib.contextmanager
def activate(obs):
    """Install ``obs`` as the active sink for the dynamic extent of a
    run; ``obs=None`` deactivates (nested runs stay silent)."""
    global _ACTIVE
    _STACK.append(_ACTIVE)
    _ACTIVE = obs
    try:
        yield obs
    finally:
        _ACTIVE = _STACK.pop()


# ---------------------------------------------------------------- hooks


def count(name: str, n: int = 1, **labels) -> None:
    obs = _ACTIVE
    if obs is not None and obs.counters is not None:
        obs.counters.inc(name, n, **labels)


def count_new_shape(name: str, shape: str) -> bool:
    """Increment a shape counter only the first time ``shape`` is seen
    this run.  Returns True when it counted."""
    obs = _ACTIVE
    if obs is None or obs.counters is None:
        return False
    if obs.counters.get(name, shape=shape) == 0:
        obs.counters.inc(name, shape=shape)
        return True
    return False


def span(name: str):
    """A span context manager — the shared no-op unless a tracer is
    active (tracing is opt-in)."""
    obs = _ACTIVE
    if obs is not None and obs.tracer is not None:
        return obs.tracer.span(name)
    return NULL_SPAN


def record_forecast(pred_inbound) -> None:
    """Scheduler-side hook: the slot's per-region demand forecast
    (picked up by the series recorder at slot close)."""
    obs = _ACTIVE
    if obs is not None and obs.series is not None:
        obs.series.note_forecast(pred_inbound)
