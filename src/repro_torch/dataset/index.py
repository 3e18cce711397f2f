"""Dataset-level spatial index: prune whole shards before per-page pruning.

The manifest's per-shard MBRs are the shard-level analog of the paper's §4
per-page [min,max] statistics: a query rectangle drops every shard whose MBR
misses it without opening the shard file, then delegates to each surviving
shard's own :class:`~repro_torch.core.index.SpatialIndex` for page pruning.

Layout mirrors :class:`~repro_torch.core.index.SpatialIndex` — structure-of-arrays
over the manifest, vectorized queries, and :meth:`shard_runs` returning
maximal runs of consecutive hit shards, symmetric to ``page_runs`` (shards
are numbered in manifest order, which is SFC-key order, so spatially-close
queries hit consecutive shards).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.filters import ColumnZones, Predicate, canonical_bbox

from .manifest import DatasetManifest


class DatasetIndex:
    """In-memory SoA view of the manifest MBRs with vectorized pruning."""

    def __init__(self, manifest: DatasetManifest):
        self.manifest = manifest
        n = manifest.n_shards
        self._xmin = np.empty(n, dtype=np.float64)
        self._ymin = np.empty(n, dtype=np.float64)
        self._xmax = np.empty(n, dtype=np.float64)
        self._ymax = np.empty(n, dtype=np.float64)
        self.n_records = np.empty(n, dtype=np.int64)
        self.n_pages = np.empty(n, dtype=np.int64)
        self.data_bytes = np.empty(n, dtype=np.int64)
        for i, s in enumerate(manifest.shards):
            self._xmin[i], self._ymin[i], self._xmax[i], self._ymax[i] = s.mbr
            self.n_records[i] = s.n_records
            self.n_pages[i] = s.n_pages
            self.data_bytes[i] = s.data_bytes
        self._zones: dict[str, ColumnZones] | None = None

    def zone_lookup(self, column: str) -> ColumnZones | None:
        """Per-shard zone-map statistics of one extra column.

        Built lazily from the manifest's ``ShardInfo.zone_maps``. A shard
        without a zone map for the column (older snapshots, pre-zone-map
        files) contributes unknown stats (NaN min/max, ``-1`` counts) and is
        never pruned. Returns None when *no* shard knows the column.
        """
        if self._zones is None:
            zones: dict[str, ColumnZones] = {}
            cols = set()
            for s in self.manifest.shards:
                cols.update(s.zone_maps or ())
            n = len(self)
            for k in sorted(cols):
                vmin = np.full(n, np.nan)
                vmax = np.full(n, np.nan)
                nnan = np.full(n, -1, np.int64)
                count = np.full(n, -1, np.int64)
                for i, s in enumerate(self.manifest.shards):
                    z = (s.zone_maps or {}).get(k)
                    if z is None:
                        continue
                    # min/max of None = no non-NaN values in the shard
                    vmin[i] = np.inf if z["min"] is None else z["min"]
                    vmax[i] = -np.inf if z["max"] is None else z["max"]
                    nnan[i] = z["nnan"]
                    count[i] = z["count"]
                zones[k] = ColumnZones(vmin, vmax, nnan, count)
            self._zones = zones
        return self._zones.get(column)

    def __len__(self) -> int:
        return len(self._xmin)

    @property
    def total_bytes(self) -> int:
        return int(self.data_bytes.sum())

    @property
    def total_pages(self) -> int:
        return int(self.n_pages.sum())

    def query(
        self,
        bbox: tuple[float, float, float, float] | None,
        filter: Predicate | None = None,
    ) -> np.ndarray:
        """Indices of shards that may satisfy ``bbox`` ∧ ``filter``.

        ``bbox=None`` means no spatial constraint; an empty bbox under
        :func:`~repro_torch.core.filters.canonical_bbox` (NaN bound or inverted
        extent) hits nothing — the same rule the page- and record-level
        tests apply, so every pruning level answers consistently. ``filter``
        prunes from the manifest alone via the persisted per-shard zone
        maps, before any shard file is opened.
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

    def shard_runs(self, bbox, hit: np.ndarray | None = None) -> list[tuple[int, int]]:
        """Maximal runs of consecutive hit shards: ``(s0, s1)``.

        Shards ``s0 .. s1-1`` all intersect ``bbox``; runs are emitted in
        manifest (SFC) order — the dataset-level mirror of
        :meth:`repro_torch.core.index.SpatialIndex.page_runs`. Pass ``hit`` (a
        ``query(bbox)`` result) to avoid re-running the query.
        """
        if hit is None:
            hit = self.query(bbox)
        if len(hit) == 0:
            return []
        brk = np.flatnonzero(np.diff(hit) != 1) + 1
        starts = np.concatenate([[0], brk])
        ends = np.append(brk, len(hit))
        return [(int(hit[s]), int(hit[e - 1]) + 1) for s, e in zip(starts, ends)]

    def selectivity(self, bbox) -> float:
        """Fraction of shards the query must open (1.0 = no pruning).

        An empty dataset reports 1.0 — "nothing was pruned" — not 0.0,
        which downstream pruning-ratio accounting would read as perfect
        pruning.
        """
        if not len(self):
            return 1.0
        return len(self.query(bbox)) / len(self)
