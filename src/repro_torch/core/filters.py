"""Attribute predicates pushed down three granularities (zone → page → record).

A small conjunctive AST over the file's extra (per-record attribute) columns:

- :class:`Range` — closed numeric interval ``lo <= v <= hi`` (NaN never
  matches, mirroring SQL comparison semantics),
- :class:`In` — membership in a finite value set,
- :class:`IsNull` — the value is NaN (float columns only),
- :class:`And` — conjunction.

Each node answers at two levels:

- :meth:`Predicate.mask` — the *exact* record-level answer as a numpy bool
  mask over decoded column arrays. This is the oracle every pruning level
  must agree with.
- :meth:`Predicate.zone_mask` — a *conservative* "may this zone contain a
  match?" test over per-zone min/max/NaN-count statistics (a shard's zone
  map or a page's footer stats). False means provably no match, so the zone
  can be skipped without reading it; True is always safe. Because stored
  stats pass through ``float`` (and may have rounded e.g. large int64
  values), bounds are widened outward by one ulp before testing.

Zone statistics are the vectorized :class:`ColumnZones` (one entry per
shard or page): ``vmin``/``vmax`` are float64 with NaN meaning *unknown*
and ``(+inf, -inf)`` meaning *no non-NaN values*; ``nnan``/``count`` are
int64 with ``-1`` meaning unknown. Missing statistics always keep the zone.

This module also hosts :func:`canonical_bbox` — the single bbox
canonicalization rule shared by every pruning level (shard MBRs, page
stats, and the record-level kernel's query keys): a bbox with a NaN bound
or inverted extent matches nothing, at every level.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np


def canonical_bbox(bbox) -> tuple[float, float, float, float] | None:
    """Canonicalize a query bbox ``(x0, y0, x1, y1)``; None if it is empty.

    A bbox with any NaN bound or an inverted extent (``x1 < x0`` or
    ``y1 < y0``) intersects nothing. Every pruning level — shard MBRs
    (:meth:`repro_torch.dataset.index.DatasetIndex.query`), page statistics
    (:meth:`repro_torch.core.index.SpatialIndex.query`) and the record-level
    kernel (:func:`repro_torch.kernels.minmax.bbox_query_keys`) — routes through
    this helper so the same bbox produces the same answer at every level.
    """
    x0, y0, x1, y1 = (float(v) for v in bbox)
    if any(math.isnan(v) for v in (x0, y0, x1, y1)):
        return None
    if x1 < x0 or y1 < y0:
        return None
    return (x0, y0, x1, y1)


@dataclass
class ColumnZones:
    """Per-zone statistics of one column, SoA over shards or pages.

    ``vmin``/``vmax``: float64, NaN = unknown, ``(+inf, -inf)`` = zone has
    no non-NaN values. ``nnan``/``count``: int64, ``-1`` = unknown.
    """

    vmin: np.ndarray
    vmax: np.ndarray
    nnan: np.ndarray
    count: np.ndarray


# lookup(column) -> ColumnZones for that column, or None when unknown
ZoneLookup = Callable[[str], Optional[ColumnZones]]


def _widened(z: ColumnZones) -> tuple[np.ndarray, np.ndarray]:
    # stored stats went through float() and may have rounded the true
    # extremum (large int64s, float32 paths) — widen one ulp outward so the
    # zone test stays conservative. NaN (unknown) propagates through.
    return np.nextafter(z.vmin, -np.inf), np.nextafter(z.vmax, np.inf)


def _all_nan_zones(z: ColumnZones) -> np.ndarray:
    """Zones provably holding no non-NaN value (empty counts as all-NaN)."""
    return (z.nnan >= 0) & (z.count >= 0) & (z.nnan == z.count)


class Predicate:
    """Base class; see module docstring for semantics."""

    def columns(self) -> frozenset[str]:
        raise NotImplementedError

    def mask(self, extras: dict) -> np.ndarray:
        """Exact record-level bool mask over decoded column arrays."""
        raise NotImplementedError

    def zone_mask(self, lookup: ZoneLookup, n: int) -> np.ndarray:
        """Conservative per-zone "may match" mask of length ``n``."""
        raise NotImplementedError

    @property
    def key(self) -> tuple:
        """Stable hashable identity (serve-tier query dedup/caching)."""
        raise NotImplementedError

    def __and__(self, other: "Predicate") -> "And":
        return And(self, other)


def _check_bound(name: str, v) -> None:
    if v is not None and isinstance(v, float) and math.isnan(v):
        raise ValueError(f"Range {name} bound must not be NaN (use IsNull)")


@dataclass(frozen=True)
class Range(Predicate):
    """``lo <= column <= hi`` (closed; None = unbounded; NaN never matches)."""

    column: str
    lo: object = None
    hi: object = None

    def __post_init__(self):
        _check_bound("lo", self.lo)
        _check_bound("hi", self.hi)

    def columns(self) -> frozenset[str]:
        return frozenset((self.column,))

    def mask(self, extras: dict) -> np.ndarray:
        v = np.asarray(extras[self.column])
        if self.lo is None and self.hi is None:
            # pure non-null test: any comparable number matches
            return ~np.isnan(v) if v.dtype.kind == "f" else np.ones(len(v), bool)
        m = np.ones(len(v), bool)
        if self.lo is not None:
            m &= v >= self.lo  # NaN compares False
        if self.hi is not None:
            m &= v <= self.hi
        return m

    def zone_mask(self, lookup: ZoneLookup, n: int) -> np.ndarray:
        z = lookup(self.column)
        if z is None:
            return np.ones(n, bool)
        vmin, vmax = _widened(z)
        keep = np.ones(n, bool)
        with np.errstate(invalid="ignore"):
            if self.lo is not None:
                keep &= ~(vmax < self.lo)  # NaN stats stay kept
            if self.hi is not None:
                keep &= ~(vmin > self.hi)
        keep &= ~_all_nan_zones(z)
        return keep

    @property
    def key(self) -> tuple:
        return ("range", self.column, self.lo, self.hi)


@dataclass(frozen=True)
class In(Predicate):
    """``column ∈ values`` (finite set; NaN members are rejected)."""

    column: str
    values: tuple = ()

    def __post_init__(self):
        vals = tuple(self.values)
        if not vals:
            raise ValueError("In() needs at least one value")
        for v in vals:
            if isinstance(v, float) and math.isnan(v):
                raise ValueError("NaN is not a set member (use IsNull)")
        object.__setattr__(self, "values", vals)

    def columns(self) -> frozenset[str]:
        return frozenset((self.column,))

    def mask(self, extras: dict) -> np.ndarray:
        v = np.asarray(extras[self.column])
        return np.isin(v, np.asarray(self.values))

    def zone_mask(self, lookup: ZoneLookup, n: int) -> np.ndarray:
        z = lookup(self.column)
        if z is None:
            return np.ones(n, bool)
        vmin, vmax = _widened(z)
        keep = np.zeros(n, bool)
        with np.errstate(invalid="ignore"):
            for v in self.values:
                keep |= (vmin <= v) & (v <= vmax)
        keep |= np.isnan(z.vmin) | np.isnan(z.vmax)  # unknown stats keep
        keep &= ~_all_nan_zones(z)
        return keep

    @property
    def key(self) -> tuple:
        return ("in", self.column, self.values)


@dataclass(frozen=True)
class IsNull(Predicate):
    """``column`` is NaN (float columns; always False for integer columns)."""

    column: str

    def columns(self) -> frozenset[str]:
        return frozenset((self.column,))

    def mask(self, extras: dict) -> np.ndarray:
        v = np.asarray(extras[self.column])
        if v.dtype.kind == "f":
            return np.isnan(v)
        return np.zeros(len(v), bool)

    def zone_mask(self, lookup: ZoneLookup, n: int) -> np.ndarray:
        z = lookup(self.column)
        if z is None:
            return np.ones(n, bool)
        return z.nnan != 0  # -1 (unknown) keeps, 0 prunes, >0 keeps

    @property
    def key(self) -> tuple:
        return ("isnull", self.column)


@dataclass(frozen=True)
class And(Predicate):
    """Conjunction of predicates (nested Ands are flattened)."""

    preds: tuple = ()

    def __init__(self, *preds):
        flat = []
        for p in preds:
            if isinstance(p, And):
                flat.extend(p.preds)
            elif isinstance(p, Predicate):
                flat.append(p)
            else:
                raise TypeError(f"not a Predicate: {p!r}")
        if not flat:
            raise ValueError("And() needs at least one predicate")
        object.__setattr__(self, "preds", tuple(flat))

    def columns(self) -> frozenset[str]:
        return frozenset().union(*(p.columns() for p in self.preds))

    def mask(self, extras: dict) -> np.ndarray:
        m = self.preds[0].mask(extras)
        for p in self.preds[1:]:
            m = m & p.mask(extras)
        return m

    def zone_mask(self, lookup: ZoneLookup, n: int) -> np.ndarray:
        m = self.preds[0].zone_mask(lookup, n)
        for p in self.preds[1:]:
            m = m & p.zone_mask(lookup, n)
        return m

    @property
    def key(self) -> tuple:
        return ("and",) + tuple(p.key for p in self.preds)


def validate_predicate(pred, extra_schema: dict) -> Predicate:
    """Check ``pred`` references only numeric columns of ``extra_schema``."""
    if not isinstance(pred, Predicate):
        raise TypeError(f"filter must be a repro_torch.core.filters.Predicate, got {pred!r}")
    for c in sorted(pred.columns()):
        if c not in extra_schema:
            raise ValueError(
                f"filter column {c!r} not in extra columns {sorted(extra_schema)}"
            )
        if np.dtype(extra_schema[c]).kind not in "iuf":
            raise ValueError(
                f"filter column {c!r} has non-numeric dtype {extra_schema[c]!r}"
            )
    return pred
