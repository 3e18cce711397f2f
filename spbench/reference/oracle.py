"""The expected answer of every bbox read, from the generated columns alone.

:class:`Oracle` works out what the writer derives (file order, pages and
their bounds) and what a ``read_columnar(bbox, refine=True)`` of that file
returns: the pages the index reads, the records it scans, the records whose
bbox meets the query, their coordinates in file order with their levels,
and their extra columns. ``precision="float32"`` computes the same in
float32, the benchmark's control.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .ragged import Ragged, bits, ragged_ranges
from .sfc import hilbert_sort_keys


@dataclass
class Answer:
    """One read's result in plain arrays (bit patterns for the values)."""

    pages_read: int
    records_scanned: int
    n: int                      # records returned
    x: np.ndarray               # coordinate bits, survivors' values in file order
    y: np.ndarray
    rep: np.ndarray             # uint8 levels, one a value
    defn: np.ndarray
    types: np.ndarray           # uint8, one a record
    type_rep: np.ndarray
    extras: dict = field(default_factory=dict)   # name -> bits, one a record
    hit_pages: np.ndarray | None = None          # the reference's page indices


def page_splits(values_per_record: np.ndarray, page_values: int) -> list[tuple[int, int]]:
    """Record-aligned pages of about ``page_values`` values: the largest run
    of records whose values end within the target, at least one record."""
    n = len(values_per_record)
    bounds = np.concatenate([[0], np.cumsum(values_per_record)])
    pages = []
    r = 0
    while r < n:
        nxt = int(np.searchsorted(bounds, bounds[r] + page_values, side="right")) - 1
        nxt = min(max(nxt, r + 1), n)
        pages.append((r, nxt))
        r = nxt
    return pages


def stable_argsort(keys: np.ndarray, key_bits: int) -> np.ndarray:
    """``argsort(keys, kind="stable")``: one sort of each key with its index
    in the low bits where both fit in 64 bits."""
    n = len(keys)
    ib = max(1, (n - 1).bit_length())
    if key_bits + ib > 64:
        return np.argsort(keys, kind="stable")
    packed = np.sort((keys << np.uint64(ib)) | np.arange(n, dtype=np.uint64))
    return (packed & np.uint64((1 << ib) - 1)).astype(np.int64)


_VALUE_ARRAYS = ("x", "y", "xmin", "xmax", "ymin", "ymax", "pxmin", "pxmax", "pymin", "pymax")


class Oracle:
    def __init__(self, data: Ragged, extras: dict, writer: dict):
        self.x = np.ascontiguousarray(data.coords[:, 0])
        self.y = np.ascontiguousarray(data.coords[:, 1])
        self.vpr = data.values_per_record()
        if (self.vpr <= 0).any():
            raise ValueError("every record needs at least one value")
        self.starts = np.cumsum(self.vpr) - self.vpr
        self.types = data.types
        self.rep = data.rep_levels()
        self.extras = extras
        n = data.n_records
        self.n_records = n
        self.n_values = data.n_values

        xmin = np.minimum.reduceat(self.x, self.starts)
        xmax = np.maximum.reduceat(self.x, self.starts)
        ymin = np.minimum.reduceat(self.y, self.starts)
        ymax = np.maximum.reduceat(self.y, self.starts)
        rg_records = int(writer["row_group_records"])
        parts = []
        for r0 in range(0, n, rg_records):
            r1 = min(n, r0 + rg_records)
            if writer.get("sort") == "hilbert" and r1 - r0 > 1:
                cx = (xmin[r0:r1] + xmax[r0:r1]) / 2.0
                cy = (ymin[r0:r1] + ymax[r0:r1]) / 2.0
                order_bits = int(writer.get("sfc_order", 16))
                keys = hilbert_sort_keys(cx, cy, order_bits)
                parts.append(r0 + stable_argsort(keys, 2 * order_bits))
            elif writer.get("sort") in (None, "hilbert"):
                parts.append(np.arange(r0, r1))
            else:
                raise ValueError(f"no reference for sort {writer.get('sort')!r}")
        self.order = np.concatenate(parts) if parts else np.zeros(0, np.int64)
        # record bboxes in file order
        self.xmin, self.xmax = xmin[self.order], xmax[self.order]
        self.ymin, self.ymax = ymin[self.order], ymax[self.order]
        del xmin, xmax, ymin, ymax

        # pages: record ranges in file order, and their bounds
        vpr_file = self.vpr[self.order]
        p0 = []
        for r0 in range(0, n, rg_records):
            r1 = min(n, r0 + rg_records)
            p0 += [r0 + a for a, _ in page_splits(vpr_file[r0:r1], int(writer["page_values"]))]
        self.page_start = np.asarray(p0, np.int64)
        self.page_records = np.diff(np.append(self.page_start, n))
        if len(p0):
            self.pxmin = np.minimum.reduceat(self.xmin, self.page_start)
            self.pxmax = np.maximum.reduceat(self.xmax, self.page_start)
            self.pymin = np.minimum.reduceat(self.ymin, self.page_start)
            self.pymax = np.maximum.reduceat(self.ymax, self.page_start)
        self._f32 = None

    @property
    def n_pages(self) -> int:
        return len(self.page_start)

    def centres(self) -> tuple[np.ndarray, np.ndarray]:
        """Record bbox centres in file order."""
        return (self.xmin + self.xmax) / 2.0, (self.ymin + self.ymax) / 2.0

    def _arrays(self, precision: str) -> dict:
        if precision == "float64":
            return {k: getattr(self, k) for k in _VALUE_ARRAYS}
        if precision != "float32":
            raise ValueError(f"unknown precision {precision!r}")
        if self._f32 is None:
            self._f32 = {k: getattr(self, k).astype(np.float32) for k in _VALUE_ARRAYS}
        return self._f32

    def expect(self, bbox, precision: str = "float64") -> Answer:
        """The answer of ``read_columnar(bbox, refine=True)`` over every column."""
        a = self._arrays(precision)
        x0, y0, x1, y1 = (a["x"].dtype.type(v) for v in bbox)
        keep = (a["xmin"] <= x1) & (a["xmax"] >= x0) & (a["ymin"] <= y1) & (a["ymax"] >= y0)
        hit = (a["pxmin"] <= x1) & (a["pxmax"] >= x0) & (a["pymin"] <= y1) & (a["pymax"] >= y0)
        sel = self.order[keep]
        iv = ragged_ranges(self.starts[sel], self.vpr[sel])
        xs, ys = a["x"][iv], a["y"][iv]
        xs, ys = xs.astype(self.x.dtype, copy=False), ys.astype(self.y.dtype, copy=False)
        hit_pages = np.flatnonzero(hit)
        return Answer(
            pages_read=len(hit_pages),
            records_scanned=int(self.page_records[hit_pages].sum()),
            n=len(sel), x=bits(xs), y=bits(ys),
            rep=self.rep[iv], defn=np.ones(len(iv), np.uint8),
            types=self.types[sel], type_rep=np.zeros(len(sel), np.uint8),
            extras={k: bits(v[sel]) for k, v in self.extras.items()},
            hit_pages=hit_pages)
