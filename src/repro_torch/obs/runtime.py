"""The hot-path hook surface (port of ``repro/obs/runtime.py``, counters
tier only).

``Engine.run`` activates its ``Counters`` for the duration of the run and
instrumented call sites reach it through these functions; every hook is
a near-no-op when nothing is active.  Spans and the per-slot series are
not ported yet: :func:`span` and :func:`record_forecast` keep the call
sites of the reference and do nothing.
"""
from __future__ import annotations

import contextlib

_ACTIVE = None            # the innermost activated Counters (or None)
_STACK = []


@contextlib.contextmanager
def activate(counters):
    """Install ``counters`` as the active sink for the dynamic extent of a
    run; ``None`` deactivates."""
    global _ACTIVE
    _STACK.append(_ACTIVE)
    _ACTIVE = counters
    try:
        yield counters
    finally:
        _ACTIVE = _STACK.pop()


def count(name: str, n: int = 1, **labels) -> None:
    if _ACTIVE is not None:
        _ACTIVE.inc(name, n, **labels)


def count_new_shape(name: str, shape: str) -> bool:
    """Increment a shape counter only the first time ``shape`` is seen
    this run.  Returns True when it counted."""
    if _ACTIVE is None or _ACTIVE.get(name, shape=shape):
        return False
    _ACTIVE.inc(name, shape=shape)
    return True


def span(name: str):
    """Span timing is not ported yet: a no-op context."""
    return contextlib.nullcontext()


def record_forecast(pred_inbound) -> None:
    """The per-slot series recorder is not ported yet: a no-op."""
