"""The light-weight spatial index (paper §4).

The index *is* the per-page [min,max] column statistics: together the x and y
ranges of page ``i`` form its bounding box. A query rectangle
``(xmin, ymin, xmax, ymax)`` is split into the two 1-D ranges and pages whose
boxes miss either range are skipped without being read (or decompressed).

Layout is structure-of-arrays: one packed numpy array per field
(``row_group``, ``page``, ``rec_start``, ``rec_count``, ``count``,
``nbytes``, the four bbox sides, and the x/y blob offsets/sizes), built once
from the footer. Queries are pure vector ops, and :meth:`page_runs` hands the
reader maximal runs of consecutive hit pages per row group — the unit the
coalesced-I/O read path turns into single ``readinto`` calls — with no
Python-side dict/sort grouping. The legacy per-page :class:`PageIndexEntry`
view is still available through the lazy :attr:`entries` property.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .filters import ColumnZones, Predicate, canonical_bbox


@dataclass
class PageIndexEntry:
    row_group: int
    page: int
    bbox: tuple[float, float, float, float]  # xmin, ymin, xmax, ymax
    rec_start: int
    rec_count: int
    nbytes: int  # stored bytes of x+y pages (for pruning accounting)


class SpatialIndex:
    """In-memory SoA view of the footer statistics with vectorized pruning."""

    def __init__(self, footer: dict):
        rgs = footer["row_groups"]
        n = sum(len(rg["x_pages"]) for rg in rgs)
        self.row_group = np.empty(n, dtype=np.int32)
        self.page = np.empty(n, dtype=np.int32)
        self.rec_start = np.empty(n, dtype=np.int64)
        self.rec_count = np.empty(n, dtype=np.int64)
        self.count = np.empty(n, dtype=np.int64)      # values per page
        self.nbytes = np.empty(n, dtype=np.int64)     # stored x+y bytes
        self.x_offset = np.empty(n, dtype=np.int64)
        self.x_nbytes = np.empty(n, dtype=np.int64)
        self.y_offset = np.empty(n, dtype=np.int64)
        self.y_nbytes = np.empty(n, dtype=np.int64)
        self._xmin = np.empty(n, dtype=np.float64)
        self._ymin = np.empty(n, dtype=np.float64)
        self._xmax = np.empty(n, dtype=np.float64)
        self._ymax = np.empty(n, dtype=np.float64)

        i = 0
        for rg_i, rg in enumerate(rgs):
            xp, yp = rg["x_pages"], rg["y_pages"]
            assert len(xp) == len(yp), "x/y pages must be aligned"
            for p_i, (px, py) in enumerate(zip(xp, yp)):
                self.row_group[i] = rg_i
                self.page[i] = p_i
                self.rec_start[i] = px["rec_start"]
                self.rec_count[i] = px["rec_count"]
                self.count[i] = px["count"]
                self.nbytes[i] = px["nbytes"] + py["nbytes"]
                self.x_offset[i] = px["offset"]
                self.x_nbytes[i] = px["nbytes"]
                self.y_offset[i] = py["offset"]
                self.y_nbytes[i] = py["nbytes"]
                self._xmin[i] = px["vmin"]
                self._xmax[i] = px["vmax"]
                self._ymin[i] = py["vmin"]
                self._ymax[i] = py["vmax"]
                i += 1
        self._entries: list[PageIndexEntry] | None = None
        self._footer_rgs = rgs
        self._zones: dict[str, ColumnZones] | None = None

    def __len__(self) -> int:
        return len(self.row_group)

    @property
    def entries(self) -> list[PageIndexEntry]:
        """Lazy AoS view (kept for diagnostics/tests; hot paths use arrays)."""
        if self._entries is None:
            self._entries = [
                PageIndexEntry(
                    row_group=int(self.row_group[i]),
                    page=int(self.page[i]),
                    bbox=(
                        float(self._xmin[i]), float(self._ymin[i]),
                        float(self._xmax[i]), float(self._ymax[i]),
                    ),
                    rec_start=int(self.rec_start[i]),
                    rec_count=int(self.rec_count[i]),
                    nbytes=int(self.nbytes[i]),
                )
                for i in range(len(self))
            ]
        return self._entries

    @property
    def total_bytes(self) -> int:
        return int(self.nbytes.sum())

    def zone_lookup(self, column: str) -> ColumnZones | None:
        """Per-page statistics of one extra column (None when unknown).

        Built lazily from the footer's extra-column page metadata: ``vmin``/
        ``vmax`` are the page stats (NaN for pages written before NaN-safe
        stats — treated as unknown, never pruned), ``nnan`` is the per-page
        NaN count (``-1`` for files without it), ``count`` the record count.
        """
        if self._zones is None:
            zones: dict[str, ColumnZones] = {}
            cols = self._footer_rgs[0].get("extra", {}) if self._footer_rgs else {}
            n = len(self)
            for k in cols:
                vmin = np.empty(n, np.float64)
                vmax = np.empty(n, np.float64)
                nnan = np.empty(n, np.int64)
                i = 0
                for rg in self._footer_rgs:
                    for p in rg["extra"][k]:
                        vmin[i] = p["vmin"]
                        vmax[i] = p["vmax"]
                        nnan[i] = p.get("nnan", -1)
                        i += 1
                zones[k] = ColumnZones(vmin, vmax, nnan, self.rec_count.copy())
            self._zones = zones
        return self._zones.get(column)

    def query(
        self,
        bbox: tuple[float, float, float, float] | None,
        filter: Predicate | None = None,
    ) -> np.ndarray:
        """Indices of pages that may satisfy ``bbox`` ∧ ``filter``.

        ``bbox=None`` means no spatial constraint; an empty bbox under
        :func:`~repro_torch.core.filters.canonical_bbox` (NaN bound or inverted
        extent) hits nothing. ``filter`` prunes via the per-page zone
        statistics of the extra columns it references (conservative: a page
        is only dropped when its stats prove no record can match).
        """
        if bbox is None:
            hit = np.ones(len(self), bool)
        else:
            b = canonical_bbox(bbox)
            if b is None:
                return np.zeros(0, dtype=np.intp)
            qx0, qy0, qx1, qy1 = b
            hit = (
                (self._xmin <= qx1)
                & (self._xmax >= qx0)
                & (self._ymin <= qy1)
                & (self._ymax >= qy0)
            )
        if filter is not None:
            hit = hit & filter.zone_mask(self.zone_lookup, len(self))
        return np.flatnonzero(hit)

    def page_runs(self, bbox, hit: np.ndarray | None = None) -> list[tuple[int, int, int]]:
        """Maximal runs of consecutive hit pages: ``(row_group, p0, p1)``.

        Pages ``p0 .. p1-1`` of ``row_group`` all intersect ``bbox``. Runs are
        emitted in file order (entries are built sorted by row group then
        page), so the reader can turn each one into a single coalesced read.
        Pass ``hit`` (a ``query(bbox)`` result — possibly predicate-pruned)
        to avoid re-running the query.
        """
        if hit is None:
            hit = self.query(bbox)
        if len(hit) == 0:
            return []
        rgh = self.row_group[hit]
        ph = self.page[hit]
        brk = np.flatnonzero((np.diff(ph) != 1) | (np.diff(rgh) != 0)) + 1
        starts = np.concatenate([[0], brk])
        ends = np.append(brk, len(hit))
        return [
            (int(rgh[s]), int(ph[s]), int(ph[e - 1]) + 1)
            for s, e in zip(starts, ends)
        ]

    def selectivity(self, bbox) -> float:
        """Fraction of pages the query must read (1.0 = no pruning).

        An empty file reports 1.0 — "nothing was pruned" — so downstream
        pruning-ratio accounting never mistakes an empty index for a
        perfectly-pruned one.
        """
        if not len(self):
            return 1.0
        return len(self.query(bbox)) / len(self)
