"""Structured tracing: thread-aware spans, Chrome trace-event export.

A :class:`Span` is one timed stage of the scan pipeline (``plan``, ``fetch``,
``decode``, ``refine``, ``transfer`` …) with structured attributes
(``shard=``, ``rg=``). The *current* span is carried in a
:data:`contextvars.ContextVar` rather than a ``threading.local`` so an open
span stack can be handed across threads explicitly: wrap the worker callable
in ``contextvars.copy_context().run`` (what :func:`repro_torch.obs.submit` does)
and spans opened on the worker thread parent correctly under the span that
was open at submit time — the scanner's shard fan-out and the reader's
prefetch thread both use this.

The recorded events are Chrome trace-event JSON (the ``traceEvents`` array
form), loadable in Perfetto / ``chrome://tracing`` as-is:

* spans → complete events (``"ph": "X"``) with microsecond ``ts``/``dur``,
  the real OS thread id as ``tid``, and ``args`` carrying the structured
  attributes plus ``span_id``/``parent_id`` (explicit nesting, robust across
  thread hand-offs where timestamp containment alone is ambiguous);
* :meth:`Tracer.instant` → instant events (``"ph": "i"``) for point
  occurrences (a retry, a backoff, a skipped shard);
* thread names → ``"ph": "M"`` ``thread_name`` metadata events.

This module holds no global state and imports only the stdlib; the enabled
flag and the no-op fast path live in :mod:`repro_torch.obs`.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import threading
import time


class NullSpan:
    """The disabled-tracing span: one shared, allocation-free no-op.

    ``repro_torch.obs.span(...)`` returns this singleton whenever tracing is off,
    so the instrumented hot paths allocate nothing and execute only an
    attribute load, a truthiness check and two no-op method calls per
    ``with`` block.
    """

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **args):
        return self


NULL_SPAN = NullSpan()

# the innermost open span of the current context (thread *or* an explicit
# copy_context hand-off into a worker thread)
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_obs_current_span", default=None
)

_SPAN_IDS = itertools.count(1)


def current_span():
    """The innermost open span of this context (None outside any span)."""
    return _CURRENT.get()


class Span:
    """One timed, attributed stage; records itself on ``__exit__``."""

    __slots__ = ("tracer", "name", "cat", "args", "span_id", "parent_id",
                 "_t0", "_token")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.span_id = next(_SPAN_IDS)
        self.parent_id = 0

    def __enter__(self):
        parent = _CURRENT.get()
        if parent is not None:
            self.parent_id = parent.span_id
        self._token = _CURRENT.set(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _CURRENT.reset(self._token)
        self.tracer._complete(self, self._t0, t1 - self._t0)
        return False

    def add(self, **args):
        """Attach attributes discovered mid-span (e.g. survivor counts)."""
        self.args.update(args)
        return self


class Tracer:
    """Collects trace events; thread-safe; exports Chrome trace JSON."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._threads: dict[int, str] = {}
        self.epoch_ns = time.perf_counter_ns()
        self.pid = os.getpid()

    # ------------------------------------------------------------- recording
    def _tid(self) -> int:
        t = threading.current_thread()
        tid = t.ident or 0
        if tid not in self._threads:
            self._threads[tid] = t.name
        return tid

    def _complete(self, span: Span, t0_ns: int, dur_ns: int) -> None:
        ev = {
            "name": span.name,
            "cat": span.cat,
            "ph": "X",
            "ts": (t0_ns - self.epoch_ns) / 1000.0,
            "dur": dur_ns / 1000.0,
            "pid": self.pid,
            "tid": self._tid(),
            "args": dict(span.args, span_id=span.span_id,
                         parent_id=span.parent_id),
        }
        with self._lock:
            self._events.append(ev)

    def instant(self, name: str, cat: str = "event", **args) -> None:
        """Record a point event (``"ph": "i"``, thread-scoped)."""
        ev = {
            "name": name,
            "cat": cat,
            "ph": "i",
            "s": "t",
            "ts": (time.perf_counter_ns() - self.epoch_ns) / 1000.0,
            "pid": self.pid,
            "tid": self._tid(),
            "args": dict(args),
        }
        with self._lock:
            self._events.append(ev)

    # ------------------------------------------------------------ inspection
    @property
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def spans(self, name: str | None = None) -> list[dict]:
        """Completed span events, optionally filtered by name."""
        return [e for e in self.events
                if e["ph"] == "X" and (name is None or e["name"] == name)]

    def summary(self) -> list[dict]:
        """Wall-clock per stage: ``{name, count, total_ms, max_ms}`` rows,
        heaviest first. Nested spans overlap their parents by design — this
        is attribution, not a partition of the total."""
        agg: dict[str, dict] = {}
        for ev in self.events:
            if ev["ph"] != "X":
                continue
            row = agg.setdefault(
                ev["name"],
                {"name": ev["name"], "count": 0, "total_ms": 0.0, "max_ms": 0.0},
            )
            ms = ev["dur"] / 1000.0
            row["count"] += 1
            row["total_ms"] += ms
            row["max_ms"] = max(row["max_ms"], ms)
        return sorted(agg.values(), key=lambda r: -r["total_ms"])

    # ---------------------------------------------------------------- export
    def chrome_trace(self, metrics: dict | None = None) -> dict:
        """The trace as a Chrome trace-event JSON object.

        ``metrics`` (a :meth:`~repro_torch.obs.metrics.MetricsRegistry.snapshot`)
        rides along under a top-level ``"metrics"`` key; Perfetto ignores
        unknown top-level keys, so the file stays loadable.
        """
        with self._lock:
            threads = dict(self._threads)
            events = list(self._events)
        meta = [
            {"name": "thread_name", "ph": "M", "pid": self.pid, "tid": tid,
             "args": {"name": name}}
            for tid, name in sorted(threads.items())
        ]
        doc: dict = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
        if metrics is not None:
            doc["metrics"] = metrics
        return doc

    def export(self, path, metrics: dict | None = None) -> str:
        """Write the Chrome trace JSON to ``path``; returns the path."""
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(metrics=metrics), fh, indent=1,
                      default=str)
            fh.write("\n")
        return str(path)
