"""Metrics registry: counters and fixed-bucket latency histograms.

The registry turns the stack's terminal totals (:class:`ReadStats`,
:class:`SourceStats`) and its per-event timings (range-GET latency, scan
latency) into queryable time series:

* :class:`Counter` — monotonic totals (``read.retries``,
  ``pruned.shard_bytes``, ``kernel.builds``);
* :class:`Histogram` — fixed-bucket distributions with interpolated
  p50/p90/p99 estimates (``scan.latency_s``, ``scan.host_cpu_s_per_gb``,
  ``io.range_get_s``). Buckets
  are log-spaced by default so the relative quantile error is bounded by
  one bucket ratio (~12% with the default 200 buckets over [1e-7, 1e3] s);
  exact observed min/max clamp the tails.

``fold_read_stats`` / ``fold_source_stats`` lift every numeric field of a
stats object into same-named counters, so recoveries (retries, timeouts,
checksum failures, cache hits) accumulate across queries instead of dying
with each returned stats value. All classes are thread-safe (the scanner
folds from worker threads).
"""

from __future__ import annotations

import threading
from dataclasses import fields as _dc_fields, is_dataclass as _is_dataclass

import numpy as np

DEFAULT_QUANTILES = (0.5, 0.9, 0.99)


def log_buckets(lo: float = 1e-7, hi: float = 1e3, n: int = 200) -> np.ndarray:
    """Log-spaced bucket edges (n buckets => n+1 edges)."""
    return np.geomspace(lo, hi, int(n) + 1)


class Counter:
    """A monotonic (well, additive) counter."""

    __slots__ = ("name", "_lock", "value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Histogram:
    """Fixed-bucket histogram with interpolated quantile estimates.

    ``bounds`` are the bucket *edges* (ascending); observations below the
    first or at/above the last edge land in dedicated under/overflow
    buckets whose quantile bounds are clamped to the exact observed
    min/max, so tail estimates never extrapolate past real data.
    """

    __slots__ = ("name", "bounds", "_counts", "_lock",
                 "count", "sum", "min", "max")

    def __init__(self, name: str, bounds=None):
        self.name = name
        self.bounds = np.asarray(
            log_buckets() if bounds is None else bounds, np.float64)
        if len(self.bounds) < 2 or np.any(np.diff(self.bounds) <= 0):
            raise ValueError("histogram bounds must be ascending, >= 2 edges")
        # index 0 = underflow, 1..m-1 = buckets, m = overflow
        self._counts = np.zeros(len(self.bounds) + 1, np.int64)
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        i = int(np.searchsorted(self.bounds, v, side="right"))
        with self._lock:
            self._counts[i] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def _bucket_bounds(self, i: int) -> tuple[float, float]:
        m = len(self.bounds)
        lo = self.min if i == 0 else self.bounds[i - 1]
        hi = self.max if i == m else self.bounds[i]
        lo = max(float(lo), self.min)
        hi = min(float(hi), self.max)
        return lo, max(hi, lo)

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (linear interpolation within the bucket).

        Bucket counts accumulate in an exact Python int (int/float compares
        are exact in Python): a float accumulator would drift past
        ``target`` once totals exceed 2**53 and fall through to the max.
        q=0 and q=1 return the exact observed extremes.
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            total = self.count
            if total == 0:
                return float("nan")
            counts = self._counts.copy()
        if q == 0.0:
            return float(self.min)
        if q == 1.0:
            return float(self.max)
        target = q * total
        cum = 0
        for i, c in enumerate(counts):
            c = int(c)
            if c == 0:
                continue
            if cum + c >= target:
                lo, hi = self._bucket_bounds(i)
                frac = min(1.0, max(0.0, (target - cum) / c))
                return float(lo + frac * (hi - lo))
            cum += c
        return float(self.max)

    def percentiles(self, qs=DEFAULT_QUANTILES) -> dict[str, float]:
        return {f"p{int(q * 100)}": self.quantile(q) for q in qs}

    def snapshot(self) -> dict:
        with self._lock:
            count, total = self.count, self.sum
            mn = self.min if count else None
            mx = self.max if count else None
        out = {"count": count, "sum": total, "min": mn, "max": mx}
        if count:
            out.update(self.percentiles())
        return out


class MetricsRegistry:
    """Named counters and histograms, created on first touch."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def histogram(self, name: str, bounds=None) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name, bounds)
            return h

    # ------------------------------------------------------------- stats fold
    def fold_stats(self, stats, prefix: str) -> None:
        """Add every integer field of a stats dataclass into counters named
        ``{prefix}.{field}`` (duck-typed: works for ReadStats, SourceStats,
        and anything shaped like them)."""
        if _is_dataclass(stats):
            names = [f.name for f in _dc_fields(stats)]
        else:
            names = list(vars(stats))
        for name in names:
            v = getattr(stats, name)
            if isinstance(v, bool):
                continue
            if isinstance(v, (int, np.integer)):
                self.counter(f"{prefix}.{name}").inc(int(v))
            elif isinstance(v, list):  # ReadStats.failures
                self.counter(f"{prefix}.{name}").inc(len(v))

    def fold_read_stats(self, stats, prefix: str = "read") -> None:
        self.fold_stats(stats, prefix)

    def fold_source_stats(self, stats, prefix: str = "io") -> None:
        self.fold_stats(stats, prefix)

    # -------------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            hists = dict(self._histograms)
        return {
            "counters": {k: c.value for k, c in sorted(counters.items())},
            "histograms": {k: h.snapshot() for k, h in sorted(hists.items())},
        }
