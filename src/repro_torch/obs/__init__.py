"""repro_torch.obs — scan telemetry: trace spans, metrics, Perfetto export.

One switch controls the whole subsystem::

    from repro_torch import obs

    tracer = obs.enable()                       # fresh tracer + registry
    geo, extras, stats = scanner.scan(bbox=b, refine=True, device="cuda")
    obs.disable()
    tracer.export("scan_trace.json", metrics=obs.snapshot())

Instrumented code calls the module-level helpers (:func:`span`,
:func:`instant`, :func:`count`, :func:`observe`,
:func:`submit`, :func:`fold_read_stats`). **When disabled (the default)
every helper compiles down to one global check**: ``span`` returns the
shared :data:`~repro_torch.obs.trace.NULL_SPAN` singleton, the recorders
return immediately, and :func:`submit` is a plain ``pool.submit`` — the
read path's results are bit-identical with tracing on or off (enforced by
``tests/test_torch_obs.py``). A span's keyword arguments are built into a
dict before that check, so the read path's sites check first and allocate
nothing when off::

    with obs.span("page.plan", cat="plan", values=n) if obs.enabled() else obs.NULL_SPAN:
        ...

Span context crosses threads explicitly: :func:`submit` wraps the worker
callable in ``contextvars.copy_context().run`` so spans opened on scanner
workers / the reader's prefetch thread parent under the span open at submit
time. This module imports only the stdlib + numpy — the kernels, I/O layer
and reader can all use it without dependency cycles.
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager

from .metrics import (
    DEFAULT_QUANTILES,
    Counter,
    Histogram,
    MetricsRegistry,
    log_buckets,
)
from .trace import NULL_SPAN, NullSpan, Span, Tracer, current_span

__all__ = [
    "Counter", "Histogram", "MetricsRegistry", "NullSpan", "Span",
    "Tracer", "NULL_SPAN", "DEFAULT_QUANTILES", "log_buckets",
    "current_span", "enabled", "enable", "disable", "trace", "get_tracer",
    "get_registry", "span", "instant", "count", "observe",
    "submit", "fold_read_stats", "fold_source_stats", "snapshot",
    "percentiles",
]

_enabled: bool = False
_tracer: Tracer | None = None
_registry: MetricsRegistry | None = None


def enabled() -> bool:
    """Is telemetry collection on?"""
    return _enabled


def enable(*, reset: bool = True) -> Tracer:
    """Turn tracing + metrics on; returns the active tracer.

    ``reset=True`` (default) starts a fresh tracer and registry;
    ``reset=False`` resumes accumulating into the existing ones.
    """
    global _enabled, _tracer, _registry
    if reset or _tracer is None:
        _tracer = Tracer()
    if reset or _registry is None:
        _registry = MetricsRegistry()
    _enabled = True
    return _tracer


def disable() -> None:
    """Turn collection off. The tracer/registry stay readable (export,
    snapshot) until the next ``enable()``."""
    global _enabled
    _enabled = False


@contextmanager
def trace(export_path=None):
    """Enable telemetry for a block; yields the tracer, disables on exit.

    ``export_path`` additionally writes the Chrome trace JSON (with the
    metrics snapshot embedded) when the block closes.
    """
    tracer = enable()
    try:
        yield tracer
    finally:
        disable()
        if export_path is not None:
            tracer.export(export_path, metrics=snapshot())


def get_tracer() -> Tracer:
    global _tracer
    if _tracer is None:
        _tracer = Tracer()
    return _tracer


def get_registry() -> MetricsRegistry:
    global _registry
    if _registry is None:
        _registry = MetricsRegistry()
    return _registry


# ---------------------------------------------------------------- hot-path API
def span(name: str, cat: str = "scan", **args):
    """A ``with``-able span; the shared no-op singleton when disabled."""
    if not _enabled:
        return NULL_SPAN
    return Span(_tracer, name, cat, args)


def instant(name: str, cat: str = "event", **args) -> None:
    """Record a point event (retry, skip, backoff …); no-op when disabled."""
    if _enabled:
        _tracer.instant(name, cat, **args)


def count(name: str, n: int = 1) -> None:
    if _enabled:
        _registry.counter(name).inc(n)


def observe(name: str, value: float, bounds=None) -> None:
    if _enabled:
        _registry.histogram(name, bounds).observe(value)


def submit(pool, fn, /, *args, **kwargs):
    """``pool.submit`` carrying the current span context into the worker.

    ``contextvars`` do not propagate across ``ThreadPoolExecutor``
    boundaries on their own; each submission gets its own context copy (a
    single copy cannot be entered concurrently from several threads). When
    disabled this is exactly ``pool.submit(fn, *args)``.
    """
    if not _enabled:
        return pool.submit(fn, *args, **kwargs)
    return pool.submit(contextvars.copy_context().run, fn, *args, **kwargs)


def fold_read_stats(stats, prefix: str = "read") -> None:
    """Fold a finished query's ReadStats into cumulative counters."""
    if _enabled:
        _registry.fold_read_stats(stats, prefix)


def fold_source_stats(stats, prefix: str = "io") -> None:
    """Fold a SourceStats account (e.g. a failed shard attempt's partial
    deltas) into cumulative counters."""
    if _enabled:
        _registry.fold_source_stats(stats, prefix)


def percentiles(name: str, qs=DEFAULT_QUANTILES) -> dict:
    """Interpolated percentiles of a named histogram (``{"p50": ..., ...}``);
    empty when the histogram has no observations or telemetry was never
    enabled. The serve tier reads its p50/p99 from here."""
    if _registry is None:
        return {}
    h = _registry.histogram(name)
    if h.count == 0:
        return {}
    return h.percentiles(qs)


def snapshot() -> dict:
    """The metrics registry snapshot (empty shape when never enabled)."""
    if _registry is None:
        return {"counters": {}, "histograms": {}}
    return _registry.snapshot()
