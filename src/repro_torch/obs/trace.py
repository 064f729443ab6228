"""Host-side phase tracing: lightweight span timers for the slot hot path
(port of ``repro/obs/trace.py``).

A :class:`Tracer` records nested named spans (context-manager or
decorator API) with wall-clock durations from ``time.perf_counter``, two
clock reads a span.  Spans are cheap but not free, so tracing is opt-in
(``ObsConfig(trace=True)``); the default-on engine observability keeps
``tracer=None`` and every ``runtime.span(...)`` call short-circuits to a
shared no-op.

With ``xla=True`` (the reference's name for the knob, kept so that code
written against either package runs against the other: ``ObsConfig.
trace_xla``, spec ``"trace-xla"``) each span also enters a
``torch.profiler.record_function(name)`` scope, so the same phase names
show up on a ``torch.profiler`` trace beside the CUDA kernels launched
inside them.  The host spans remain the source of truth for the per-run
summary table.

A span does not synchronize the card, as the reference's does not block
on JAX's asynchronous dispatch: a span that launches a kernel holds only
the host's share of it (the launch, and whatever host work overlaps the
kernel).  Device time shows on the host clock where the host waits for
the card: ``micro.host_sync``, the greedy's one device-to-host copy a
call.

Span taxonomy used by the engine/scheduler wiring (the reference's):

* ``schedule.batch``  — the whole scheduler call for the slot
* ``macro.phase1``    — TORTA phase 1 (predictor + Sinkhorn + A_t)
* ``micro.assign``    — phase-2 greedy matching (any backend)
* ``micro.host_sync`` — the greedy's one device->host copy a call
* ``engine.apply``    — decision application (grouped/sequential)
* ``engine.slot_close`` — drain, billing, per-slot metrics
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Optional


@dataclasses.dataclass
class SpanRecord:
    name: str
    depth: int           # nesting depth at entry (0 = top level)
    parent: int          # index of the enclosing span record, -1 if none
    t_start: float       # perf_counter seconds (monotonic)
    duration_s: float = 0.0


class _Span:
    """Context manager handle for one span entry."""

    __slots__ = ("_tracer", "_name", "_idx", "_prof_ctx")

    def __init__(self, tracer: "Tracer", name: str):
        self._tracer = tracer
        self._name = name
        self._idx = -1
        self._prof_ctx = None

    def __enter__(self):
        self._idx = self._tracer._enter(self._name)
        if self._tracer.xla:
            self._prof_ctx = self._tracer._annotation(self._name)
            self._prof_ctx.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._prof_ctx is not None:
            self._prof_ctx.__exit__(exc_type, exc, tb)
            self._prof_ctx = None
        self._tracer._exit(self._idx)
        return False


class NullSpan:
    """Shared no-op span — what ``runtime.span`` returns when tracing is
    off (no allocation on the hot path)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = NullSpan()


class Tracer:
    """Span recorder with per-name aggregation."""

    def __init__(self, *, xla: bool = False,
                 clock=time.perf_counter):
        self.xla = xla
        self.clock = clock
        self.records: List[SpanRecord] = []
        self._stack: List[int] = []

    # ------------------------------------------------------------- spans

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def traced(self, name: Optional[str] = None):
        """Decorator form: ``@tracer.traced("phase")``."""
        def wrap(fn):
            label = name or fn.__qualname__

            @functools.wraps(fn)
            def inner(*args, **kwargs):
                with self.span(label):
                    return fn(*args, **kwargs)
            return inner
        return wrap

    def _annotation(self, name: str):
        from torch.profiler import record_function
        return record_function(name)

    def _enter(self, name: str) -> int:
        idx = len(self.records)
        parent = self._stack[-1] if self._stack else -1
        self.records.append(SpanRecord(
            name=name, depth=len(self._stack), parent=parent,
            t_start=self.clock()))
        self._stack.append(idx)
        return idx

    def _exit(self, idx: int) -> None:
        rec = self.records[idx]
        rec.duration_s = self.clock() - rec.t_start
        # tolerate exception unwinding closing spans out of order
        while self._stack and self._stack[-1] >= idx:
            self._stack.pop()

    # ---------------------------------------------------------- summary

    def summary(self) -> List[Dict]:
        """Per-name aggregate rows, ordered by total time descending:
        ``{name, count, total_s, mean_s, max_s, depth}`` (depth = the
        minimum nesting depth the name was seen at)."""
        agg: Dict[str, Dict] = {}
        for rec in self.records:
            row = agg.get(rec.name)
            if row is None:
                agg[rec.name] = {"name": rec.name, "count": 1,
                                 "total_s": rec.duration_s,
                                 "max_s": rec.duration_s,
                                 "depth": rec.depth}
            else:
                row["count"] += 1
                row["total_s"] += rec.duration_s
                row["max_s"] = max(row["max_s"], rec.duration_s)
                row["depth"] = min(row["depth"], rec.depth)
        rows = sorted(agg.values(), key=lambda r: -r["total_s"])
        for row in rows:
            row["mean_s"] = row["total_s"] / row["count"]
        return rows

    def summary_table(self) -> str:
        """The per-run span table (human-readable)."""
        rows = self.summary()
        if not rows:
            return "(no spans recorded)"
        lines = [f"{'span':<24} {'count':>7} {'total_s':>9} "
                 f"{'mean_ms':>9} {'max_ms':>9}"]
        for r in rows:
            indent = "  " * r["depth"]
            lines.append(
                f"{indent + r['name']:<24} {r['count']:>7} "
                f"{r['total_s']:>9.3f} {r['mean_s'] * 1e3:>9.2f} "
                f"{r['max_s'] * 1e3:>9.2f}")
        return "\n".join(lines)
