"""Multi-tenant bbox query server over a Spatial Parquet dataset.

Continuous-batching-lite for spatial scans: concurrent bbox queries are
admitted in waves, their surviving ``(shard, row group)`` sets are unioned,
and each surviving row group is decoded **once** per wave — the multi-query
refinement then answers every query of the wave from that decode, with the
queries' order-key bounds stacked along a query axis
(`decode_refine_stream_multi`). Shared state touched by a new wave is
written *per slot*, never whole-batch: here the shared state is the decoded
row-group cache, and a wave only ever adds entries keyed by
``(shard, row group, generation)``; in-flight results of earlier queries are
never rewritten.

Devices
-------

``device="cuda"`` (the default) decodes on the card with the hand-written
kernels (page-stream decode, per-record min/max) and keeps the decoded
stream and the per-record min/max keys there; ``"cpu"`` runs the same torch
chain with the kernels' plain versions on CPU tensors; ``"host"`` is the
numpy path (the JAX package's ``"cpu"``). Integer coordinate dtypes have no
float order keys, so they take the host compares whatever was asked, and
``device`` then reads ``"host"``.

Caching and identity
--------------------

Pages are record-aligned, so a record decoded from the *full* row group is
bit-identical to the same record decoded through any bbox-pruned page run.
That makes the whole row group the natural cache unit:
:meth:`~repro_torch.core.reader.SpatialParquetReader.read_row_group` reads
every page once, and each query gathers only its own hit-run record ranges
out of the shared decode. On a device the cache keeps the decoded stream
and the per-record min/max **order-key stack** there; a cache hit re-tests
new bboxes with the compare alone (`refine_minmax_multi`) — no decode, no
scan. Hit and miss paths share the exact compare of the solo fused scan, so
every query's survivor set (and therefore its results) is bit-identical to
a sequential ``scanner.scan(bbox, refine=True)``.

Attribution and telemetry
-------------------------

Each query carries its own :class:`~repro_torch.core.reader.ReadStats`,
computed from index metadata to equal what its *unshared* solo scan would
have reported (pages/bytes pruned and read, records scanned/returned) —
sharing the decode changes the cost, not the attribution. Every query runs
under an ``obs.span("serve.query")`` and folds its end-to-end latency into
the ``serve.query_latency_s`` histogram; :meth:`SpatialQueryServer.metrics`
reports p50/p99 from that histogram plus cache hit/evict counters and the
shared-decode ratio (row-group touches per actual decode).
"""

from __future__ import annotations

import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import torch_device
from repro_torch.core.columnar import GeometryColumns
from repro_torch.core.filters import validate_predicate
from repro_torch.core.reader import ReadStats, RowGroupData, _LEVEL_NAMES
from repro_torch.kernels.fp_delta import (
    decode_refine_stream_multi,
    gather_stream_values,
    ragged_ranges,
    refine_minmax_multi,
)
from repro_torch.kernels.minmax import stack_bbox_query_keys

__all__ = ["SpatialQuery", "SpatialQueryServer"]


@dataclass
class SpatialQuery:
    """One submitted bbox query and, after :meth:`SpatialQueryServer.run`,
    its results: the same ``(geo, extras, stats)`` triple a solo
    ``scanner.scan(bbox, refine=True)`` returns, plus timing."""

    qid: int
    bbox: tuple | None
    columns: tuple | None = None
    # attribute predicate (repro_torch.core.filters.Predicate); evaluated against
    # the shared row-group decodes so results equal a solo
    # ``scanner.scan(bbox, refine=True, filter=...)``
    filter: object | None = None
    geo: GeometryColumns | None = None
    extras: dict = field(default_factory=dict)
    stats: ReadStats | None = None
    done: bool = False
    t_submit: float = 0.0  # perf_counter timestamps (monotonic)
    t_done: float = 0.0

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit


@dataclass
class _HostChunkState:
    """Per-launch-chunk cache state, host compare flavor: decoded values
    plus the NaN-propagating per-record bbox statistics (float64; zero-count
    records hold NaN so every compare drops them, matching
    ``_bbox_keep_mask``)."""

    rec_lo: int
    rec_hi: int
    x: np.ndarray
    y: np.ndarray
    starts: np.ndarray  # chunk-local value start per record
    counts: np.ndarray
    xmin: np.ndarray
    xmax: np.ndarray
    ymin: np.ndarray
    ymax: np.ndarray

    def keep(self, bbox) -> np.ndarray:
        qx0, qy0, qx1, qy1 = bbox
        with np.errstate(invalid="ignore"):
            return ((self.xmin <= qx1) & (self.xmax >= qx0)
                    & (self.ymin <= qy1) & (self.ymax >= qy0))

    def gather(self, sub: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        iv = ragged_ranges(self.starts[sub], self.counts[sub])
        return self.x[iv], self.y[iv]


@dataclass
class _DevChunkState:
    """Device flavor: the decoded stream, the (R, 4) per-record min/max key
    bits and the record-validity operand stay on the device; the record
    slices (host arrays) drive survivor gathers. The decode's operands
    (packed words, token offsets, widths, anchors) are not kept."""

    rec_lo: int
    rec_hi: int
    bits: torch.Tensor
    mm: torch.Tensor
    valid: torch.Tensor
    x_start: np.ndarray
    y_start: np.ndarray
    counts: np.ndarray
    width: int

    def keep_multi(self, qkeys, qvalid) -> np.ndarray:
        return refine_minmax_multi(self.mm, self.valid, qkeys, qvalid,
                                   width=self.width)

    def gather(self, sub: np.ndarray, dtype) -> tuple[np.ndarray, np.ndarray]:
        ix = ragged_ranges(self.x_start[sub], self.counts[sub])
        iy = ragged_ranges(self.y_start[sub], self.counts[sub])
        return (gather_stream_values(self.bits, ix, dtype),
                gather_stream_values(self.bits, iy, dtype))


def _host_chunk_stats(rec_lo, rec_hi, x, y, vcounts) -> _HostChunkState:
    counts = np.asarray(vcounts, np.int64)
    starts = np.cumsum(counts) - counts
    n = len(counts)
    mins = np.full((4, n), np.nan)
    nz = counts > 0
    if nz.any():
        s = starts[nz]
        xs = x.astype(np.float64, copy=False)
        ys = y.astype(np.float64, copy=False)
        mins[0, nz] = np.minimum.reduceat(xs, s)
        mins[1, nz] = np.maximum.reduceat(xs, s)
        mins[2, nz] = np.minimum.reduceat(ys, s)
        mins[3, nz] = np.maximum.reduceat(ys, s)
    return _HostChunkState(rec_lo, rec_hi, x, y, starts, counts,
                           mins[0], mins[1], mins[2], mins[3])


@dataclass
class _CacheEntry:
    data: RowGroupData
    chunks: list  # _HostChunkState | _DevChunkState, record order


class _RowGroupCache:
    """LRU over decoded row groups, keyed ``(shard, rg, generation)``.

    The generation is bumped by :meth:`SpatialQueryServer.invalidate` (e.g.
    after the dataset is rewritten in place); stale-generation entries can
    never be returned because the key includes it, and they are dropped
    eagerly so device memory is released."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._d: OrderedDict[tuple, _CacheEntry] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key) -> _CacheEntry | None:
        e = self._d.get(key)
        if e is None:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return e

    def put(self, key, entry: _CacheEntry) -> None:
        self._d[key] = entry
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
            self.evictions += 1

    def drop_all(self) -> None:
        self._d.clear()

    def __len__(self) -> int:
        return len(self._d)


class SpatialQueryServer:
    """Serve concurrent bbox queries over one dataset with shared decodes.

    ``device="cuda"`` (the default) keeps decoded row groups on the card and
    answers each wave's queries from one decode per row group; ``"cpu"``
    runs the same chain on CPU tensors; ``"host"`` decodes and compares with
    numpy. Integer coordinates take the host compares (like the solo fused
    scan). ``cache_rgs`` bounds the decoded-row-group LRU; ``max_wave``
    bounds how many pending queries join one admission wave. Queries always
    refine (results are exact, identical to ``scan(bbox, refine=True)``); a
    ``bbox=None`` query returns the full dataset.
    """

    def __init__(self, scanner, *, device: str = "cuda", cache_rgs: int = 32,
                 max_wave: int = 64):
        if device not in ("cuda", "cpu", "host"):
            raise ValueError(
                f"device must be 'cuda', 'cpu' or 'host', got {device!r}")
        if device != "host":
            torch_device(device)  # "cuda" without a card raises here
        self.scanner = scanner
        self._device_requested = device
        self.coord_dtype = np.dtype(scanner.manifest.coord_dtype)
        # device refinement needs float order keys; integer coordinates
        # take the host compares (as the solo fused scan refines them)
        self.device = device if self.coord_dtype.kind == "f" else "host"
        self.width = self.coord_dtype.itemsize * 8
        self.cache = _RowGroupCache(cache_rgs)
        self.max_wave = int(max_wave)
        self.generation = 0
        # catalog-backed scanners: pin the generation the open readers point
        # at, so a background compaction's GC can never delete shard files
        # out from under them mid-wave
        self.data_generation = getattr(scanner, "generation", 0)
        catalog = getattr(scanner, "catalog", None)
        self._gen_pin = (catalog.pin(self.data_generation)
                         if catalog is not None else None)
        self.pending: deque[SpatialQuery] = deque()
        self._next_qid = 0
        self._readers: dict[int, object] = {}
        # shared-decode accounting: touches / decodes ≈ how many solo decodes
        # one shared decode replaced
        self.queries_total = 0
        self.waves = 0
        self.rg_touches = 0
        self.rg_decodes = 0

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        for r in self._readers.values():
            r.close()
        self._readers.clear()
        self.cache.drop_all()
        if self._gen_pin is not None:
            self._gen_pin.release()
            self._gen_pin = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def invalidate(self) -> None:
        """Invalidate every cached decode (dataset mutated in place)."""
        self.generation += 1
        self.cache.drop_all()

    def _sync_generation(self) -> bool:
        """Adopt a newer catalog generation before admitting a wave.

        Returns True when a commit (e.g. background compaction) moved the
        head since the last wave: open shard readers are closed, the decoded
        row-group cache is invalidated (its keys include the bumped
        ``generation``, so stale decodes are unreachable *and* dropped), the
        schema-derived state is re-derived, and the server's pin moves to
        the new generation so its files outlive the next GC.
        """
        refresh = getattr(self.scanner, "refresh", None)
        if refresh is None:
            return False
        gen = refresh()
        if gen == self.data_generation:
            return False
        for r in self._readers.values():
            r.close()
        self._readers.clear()
        self.invalidate()
        self.coord_dtype = np.dtype(self.scanner.manifest.coord_dtype)
        self.device = (self._device_requested
                       if self.coord_dtype.kind == "f" else "host")
        self.width = self.coord_dtype.itemsize * 8
        if self._gen_pin is not None:
            new_pin = self.scanner.catalog.pin(gen)
            self._gen_pin.release()
            self._gen_pin = new_pin
        obs.instant("serve.generation_bump", cat="serve",
                    old=self.data_generation, new=gen)
        self.data_generation = gen
        return True

    def _reader(self, shard_i: int):
        r = self._readers.get(shard_i)
        if r is None:
            r = self._readers[shard_i] = self.scanner.open_shard(shard_i)
        return r

    # ------------------------------------------------------------------ API
    def submit(self, bbox=None, columns=None, filter=None) -> SpatialQuery:
        if filter is not None:
            validate_predicate(filter, self.scanner.extra_schema)
        q = SpatialQuery(self._next_qid, bbox, columns, filter,
                         t_submit=time.perf_counter())
        self._next_qid += 1
        self.pending.append(q)
        return q

    def run(self) -> list[SpatialQuery]:
        """Drain the pending queue in admission waves; returns the completed
        queries in submission order."""
        out = []
        while self.pending:
            self._sync_generation()
            wave = [self.pending.popleft()
                    for _ in range(min(self.max_wave, len(self.pending)))]
            self._run_wave(wave)
            out.extend(wave)
        return out

    def metrics(self) -> dict:
        m = {
            "queries": self.queries_total,
            "waves": self.waves,
            "rg_touches": self.rg_touches,
            "rg_decodes": self.rg_decodes,
            "shared_decode_ratio":
                self.rg_touches / max(1, self.rg_decodes),
            "cache_hits": self.cache.hits,
            "cache_misses": self.cache.misses,
            "cache_evictions": self.cache.evictions,
            "cache_entries": len(self.cache),
        }
        m.update({f"latency_{k}": v
                  for k, v in obs.percentiles("serve.query_latency_s").items()})
        return m

    # ------------------------------------------------------------ internals
    def _plan(self, q: SpatialQuery):
        """Shard/page pruning + metadata-only ReadStats for one query —
        exactly the accounting of its solo ``scanner.scan``."""
        dindex = self.scanner.index
        hits = [int(i) for i in dindex.query(q.bbox, filter=q.filter)]
        hit_set = set(hits)
        stats = ReadStats(shards_total=len(dindex), shards_read=len(hits))
        for i, shard in enumerate(self.scanner.manifest.shards):
            if i not in hit_set:
                stats.pages_total += shard.n_pages
                stats.bytes_total += shard.data_bytes
        want_extra = (list(self.scanner.extra_schema) if q.columns is None
                      else [c for c in q.columns
                            if c in self.scanner.extra_schema])
        # the solo scan also fetches the predicate's columns (then trims
        # them from the output); mirror that in the byte attribution
        read_extra = want_extra if q.filter is None else want_extra + sorted(
            c for c in q.filter.columns() if c not in want_extra)
        plan: dict[tuple[int, int], list[tuple[int, int]]] = {}
        for shard_i in hits:
            r = self._reader(shard_i)
            idx = r.index
            stats.pages_total += len(idx)
            stats.bytes_total += r._data_bytes
            runs_by_rg: dict[int, list[tuple[int, int]]] = {}
            for rg_i, p0, p1 in idx.page_runs(
                    q.bbox, hit=idx.query(q.bbox, filter=q.filter)):
                runs_by_rg.setdefault(rg_i, []).append((p0, p1))
            for rg_i, runs in runs_by_rg.items():
                plan[(shard_i, rg_i)] = runs
                rg = r.footer["row_groups"][rg_i]
                base = int(np.searchsorted(idx.row_group, rg_i, side="left"))
                stats.bytes_read += sum(
                    rg[name]["nbytes"] for name in _LEVEL_NAMES)
                for p0, p1 in runs:
                    j0, j1 = base + p0, base + p1 - 1
                    stats.pages_read += p1 - p0
                    stats.records_scanned += int(
                        idx.rec_start[j1] + idx.rec_count[j1]
                        - idx.rec_start[j0])
                    stats.bytes_read += int(
                        idx.x_nbytes[j0 : j1 + 1].sum()
                        + idx.y_nbytes[j0 : j1 + 1].sum())
                    for k in read_extra:
                        stats.bytes_read += sum(
                            rg["extra"][k][p]["nbytes"] for p in range(p0, p1))
        return hits, plan, want_extra, stats

    def _fill_entry(self, shard_i: int, rg_i: int, qkeys, qvalid):
        """Cache miss: decode the whole row group once. On a device the
        *current wave's* multi-query refinement follows the decode, and its
        keep matrix is returned alongside the new entry."""
        r = self._reader(shard_i)
        self.rg_decodes += 1
        data = r.read_row_group(rg_i, device=self.device)
        chunks: list = []
        wave_keep: np.ndarray | None = None
        if self.device == "host":
            chunks.append(_host_chunk_stats(
                0, data.n_records, data.x, data.y, data.rec_vcounts))
        else:
            wave_keep = np.zeros((len(qkeys), data.n_records), bool)
            for ch in data.chunks:
                vc = data.rec_vcounts[ch.rec_lo : ch.rec_hi]
                if ch.kind == "host":
                    chunks.append(_host_chunk_stats(
                        ch.rec_lo, ch.rec_hi, ch.x, ch.y, vc))
                    continue
                res = decode_refine_stream_multi(ch.stream, ch.aux, qkeys,
                                                 qvalid, device=self.device)
                chunks.append(_DevChunkState(
                    ch.rec_lo, ch.rec_hi, res.bits, res.mm, res.valid,
                    ch.aux.x_start, ch.aux.y_start, ch.aux.counts,
                    self.width))
                wave_keep[:, ch.rec_lo : ch.rec_hi] = res.keep
            # the chunk states hold what later waves need; the host-built
            # streams are not kept in the cache
            data.chunks = None
        return _CacheEntry(data, chunks), wave_keep

    def _rg_keep(self, entry: _CacheEntry, bboxes, filters, qkeys, qvalid,
                 wave_keep) -> np.ndarray:
        """(Q, n_records) survivor matrix for this row group: the fused miss
        launch's matrix when fresh, else compare-only re-tests of the cached
        statistics. ``bbox=None`` rows keep everything; a query's attribute
        predicate then ANDs its exact record mask into its row (masks are
        memoized per predicate key, so same-predicate queries in a wave
        evaluate it once per row group)."""
        n_rec = entry.data.n_records
        keep = np.zeros((len(bboxes), n_rec), bool)
        dev_done = wave_keep is not None
        dev_keep = wave_keep
        if not dev_done and any(isinstance(c, _DevChunkState)
                                for c in entry.chunks):
            dev_keep = np.zeros((len(bboxes), n_rec), bool)
            for c in entry.chunks:
                if isinstance(c, _DevChunkState):
                    dev_keep[:, c.rec_lo : c.rec_hi] = c.keep_multi(
                        qkeys, qvalid)
        for c in entry.chunks:
            if isinstance(c, _DevChunkState):
                keep[:, c.rec_lo : c.rec_hi] = dev_keep[:, c.rec_lo : c.rec_hi]
            else:
                for qi, bbox in enumerate(bboxes):
                    if bbox is not None:
                        keep[qi, c.rec_lo : c.rec_hi] = c.keep(bbox)
        for qi, bbox in enumerate(bboxes):
            if bbox is None:
                keep[qi, :] = True
        masks: dict[tuple, np.ndarray] = {}
        for qi, pred in enumerate(filters):
            if pred is None:
                continue
            attr = masks.get(pred.key)
            if attr is None:
                attr = masks[pred.key] = pred.mask(
                    {k: entry.data.extras[k] for k in pred.columns()})
            keep[qi, :] &= attr
        return keep

    def _run_wave(self, wave: list[SpatialQuery]) -> None:
        self.waves += 1
        self.queries_total += len(wave)
        with obs.span("serve.wave", cat="serve", queries=len(wave)):
            plans = [self._plan(q) for q in wave]
            # (Q, 4, 2) stacked order-key bounds for the whole wave; a
            # bbox=None query gets an invalid (all-False) row that _rg_keep
            # rewrites to all-True — it must not be fenced in key space
            qkeys, qvalid = stack_bbox_query_keys(
                [q.bbox if q.bbox is not None else (np.nan,) * 4
                 for q in wave], self.coord_dtype)
            bboxes = [q.bbox for q in wave]
            filters = [q.filter for q in wave]

            acc = [_QueryAccum(list(self.scanner.extra_schema)
                               if q.columns is None else
                               [c for c in q.columns
                                if c in self.scanner.extra_schema])
                   for q in wave]
            union = sorted({key for _, plan, _, _ in plans for key in plan})
            for shard_i, rg_i in union:
                touching = [qi for qi, (_, plan, _, _) in enumerate(plans)
                            if (shard_i, rg_i) in plan]
                self.rg_touches += len(touching)
                key = (shard_i, rg_i, self.generation)
                entry = self.cache.get(key)
                wave_keep = None
                if entry is None:
                    entry, wave_keep = self._fill_entry(
                        shard_i, rg_i, qkeys, qvalid)
                    self.cache.put(key, entry)
                keep = self._rg_keep(entry, bboxes, filters, qkeys, qvalid,
                                     wave_keep)
                idx = self._reader(shard_i).index
                base = int(np.searchsorted(idx.row_group, rg_i, side="left"))
                vc = entry.data.rec_vcounts
                for qi in touching:
                    runs = plans[qi][1][(shard_i, rg_i)]
                    a = acc[qi]
                    rec_parts = []
                    for p0, p1 in runs:
                        j0, j1 = base + p0, base + p1 - 1
                        r0 = int(idx.rec_start[j0])
                        r1 = int(idx.rec_start[j1] + idx.rec_count[j1])
                        entry.data.levels.append_run(a.level_parts, r0, r1)
                        a.keep_parts.append(keep[qi, r0:r1])
                        for k in a.want_extra:
                            a.extra_parts[k].append(
                                entry.data.extras[k][r0:r1])
                        rec_parts.append(np.arange(r0, r1))
                    recs = (np.concatenate(rec_parts) if rec_parts
                            else np.zeros(0, np.int64))
                    kept = recs[keep[qi, recs]]
                    for c in entry.chunks:
                        sub = kept[(kept >= c.rec_lo) & (kept < c.rec_hi)] \
                            - c.rec_lo
                        if isinstance(c, _DevChunkState):
                            xv, yv = c.gather(sub, self.coord_dtype)
                        else:
                            xv, yv = c.gather(sub)
                        a.x_parts.append(xv)
                        a.y_parts.append(yv)

            for q, (hits, _, want_extra, stats), a in zip(wave, plans, acc):
                self._finalize(q, hits, want_extra, stats, a)

    def _finalize(self, q: SpatialQuery, hits, want_extra,
                  stats: ReadStats, a: "_QueryAccum") -> None:
        """Assemble one query's result exactly like the solo fused scan's
        tail (level compaction by the record-aligned cumsum trick)."""
        with obs.span("serve.query", cat="serve", qid=q.qid,
                      shards=len(hits)) as sp:
            self._finalize_inner(q, hits, want_extra, stats, a)
            sp.add(records=stats.records_returned)
        obs.observe("serve.query_latency_s", q.latency_s)

    def _finalize_inner(self, q: SpatialQuery, hits, want_extra,
                        stats: ReadStats, a: "_QueryAccum") -> None:
        do_refine = q.bbox is not None or q.filter is not None
        keep_all = (np.concatenate(a.keep_parts) if a.keep_parts
                    else np.zeros(0, bool))
        types_parts, type_rep_parts, rep_parts, defn_parts = a.level_parts
        if types_parts:
            types = np.concatenate(types_parts)
            type_rep = np.concatenate(type_rep_parts)
            rep = np.concatenate(rep_parts)
            defn = np.concatenate(defn_parts)
            if do_refine:
                slot_keep = keep_all[np.cumsum(rep == 0) - 1]
                type_keep = keep_all[np.cumsum(type_rep == 0) - 1]
                types = types[type_keep]
                type_rep = type_rep[type_keep]
                rep = rep[slot_keep]
                defn = defn[slot_keep]
            x = (np.concatenate(a.x_parts) if a.x_parts
                 else np.zeros(0, self.coord_dtype))
            y = (np.concatenate(a.y_parts) if a.y_parts
                 else np.zeros(0, self.coord_dtype))
            q.geo = GeometryColumns(types, type_rep, rep, defn, x, y)
        else:
            q.geo = None
        if hits:
            extras = {
                k: (np.concatenate(a.extra_parts[k]) if a.extra_parts[k]
                    else np.zeros(0, np.dtype(self.scanner.extra_schema[k])))
                for k in want_extra
            }
            if do_refine and q.geo is not None:
                extras = {k: v[keep_all] for k, v in extras.items()}
        else:
            extras = {}
        q.extras = extras
        stats.records_returned = q.geo.n_records if q.geo is not None else (
            len(next(iter(extras.values()))) if extras else 0)
        q.stats = stats
        q.done = True
        q.t_done = time.perf_counter()


class _QueryAccum:
    """Per-query result parts, appended in the query's own scan order."""

    def __init__(self, want_extra):
        self.want_extra = want_extra
        self.level_parts = ([], [], [], [])
        self.keep_parts: list[np.ndarray] = []
        self.x_parts: list[np.ndarray] = []
        self.y_parts: list[np.ndarray] = []
        self.extra_parts = {k: [] for k in want_extra}
