"""Async dataset scanner: fan a bbox query out over surviving shards.

The scan pipeline per query:

1. :class:`DatasetIndex` prunes whole shards by MBR (no file opened).
2. Surviving shards are submitted to a thread pool in manifest order; each
   worker opens its shard, runs the coalesced-range ``read_columnar`` path
   (per-page pruning + single ``readinto`` per merged run), and decodes.
   With ``max_workers >= 2`` the blocking range reads of shard N+1 overlap
   the numpy decode of shard N (file I/O releases the GIL); within a shard,
   the reader additionally double-buffers row groups.
3. Results are gathered in submission order — concatenated geometry/extra
   columns are **bit-identical** to a sequential shard-by-shard read,
   regardless of worker completion order.

Devices: ``device="cuda"`` (the default) runs each shard's page decode on
the card with the CUDA kernels; with ``refine=True`` the per-record bbox
test follows the decode there (only surviving records transfer), and
``keep_on_device=True`` merges shard results into
:class:`~repro_torch.core.columnar.TorchCoords` on the card without any
host round-trip. ``"cpu"`` runs the same torch chain with the kernels'
plain versions on CPU tensors; ``"host"`` is the reader's numpy path. (The
JAX package's ``"cpu"`` is this ``"host"``, its ``"jax"`` this
``"cuda"``.) The device is checked before any shard is opened, so a scan
on ``"cuda"`` without a card raises instead of failing shard by shard.

Aggregated :class:`~repro_torch.core.reader.ReadStats` merge every scanned shard's
account plus the page/byte totals of pruned shards (read side zero), so
pruning ratios are measured against the whole dataset.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch import obs
from repro_torch._device import torch_device
from repro_torch.core.columnar import GeometryColumns, assemble
from repro_torch.core.geometry import Geometry
from repro_torch.core.reader import ReadStats, SpatialParquetReader
from repro_torch.core.writer import concat_columns
from repro_torch.io.source import LocalFileSource, SourceStats

from .catalog import Catalog
from .errors import ShardFailure, ShardReadError
from .index import DatasetIndex
from .manifest import DatasetManifest, shard_path

ON_ERROR_POLICIES = ("raise", "retry", "skip")


class SpatialDatasetScanner:
    """Query interface over a sharded Spatial Parquet dataset.

    ``on_error`` sets the degraded-mode policy for shards whose reads fail
    even after the byte source's own retry/backoff: ``"raise"`` (default)
    wraps the cause in an attributed :class:`ShardReadError`; ``"retry"``
    re-opens the failing shard from scratch up to ``shard_retries`` more
    times (a fresh reader + source per attempt, so poisoned state cannot
    carry over) and raises only when those are exhausted; ``"skip"`` does
    the same retries but then drops the shard, recording a
    :class:`ShardFailure` in ``stats.failures`` — the scan returns every
    healthy shard's records, bit-identical to a clean scan minus the skipped
    shards.

    ``source_factory``, if given, maps a shard's absolute path to a
    :class:`~repro_torch.io.source.ByteRangeSource` — the hook that points a scan
    at remote storage (e.g. ``lambda p: RemoteRangeSource(server_for(p))``)
    without the scanner knowing anything about transports.

    Snapshot isolation: every scan **pins** one committed catalog generation
    for its whole duration, so a concurrent compaction / rewrite commit (and
    the GC that follows it) can neither change nor delete what the scan is
    reading — results are bit-identical to running against that generation
    alone. By default each scan pins the newest generation at its start;
    ``pin_generation=N`` pins generation ``N`` for the scanner's lifetime
    instead (release it with :meth:`close`). Legacy manifest-only
    directories behave as generation 0.
    """

    def __init__(self, root, *, max_workers: int = 4,
                 coalesce_max_gap: int = 1 << 16, prefetch_row_groups: int = 1,
                 on_error: str = "raise", shard_retries: int = 1,
                 source_factory=None, verify_checksums: bool = True,
                 pin_generation: int | None = None):
        self.root = str(root)
        self.catalog = Catalog.open(root)
        self._pin = (self.catalog.pin(pin_generation)
                     if pin_generation is not None else None)
        snap = (self._pin.snapshot if self._pin is not None
                else self.catalog.head_snapshot())
        self.generation = snap.generation
        self.manifest = snap.manifest
        self.index = DatasetIndex(self.manifest)
        self._views: dict[int, tuple[DatasetManifest, DatasetIndex]] = {
            self.generation: (self.manifest, self.index)}
        self.max_workers = max(1, int(max_workers))
        self.coalesce_max_gap = int(coalesce_max_gap)
        self.prefetch_row_groups = int(prefetch_row_groups)
        if on_error not in ON_ERROR_POLICIES:
            raise ValueError(
                f"on_error must be one of {ON_ERROR_POLICIES}, got {on_error!r}")
        self.on_error = on_error
        self.shard_retries = max(0, int(shard_retries))
        self.source_factory = source_factory
        self.verify_checksums = bool(verify_checksums)
        self.extra_schema = dict(self.manifest.extra_schema)
        self.n_records = self.manifest.n_records

    # ----------------------------------------------------------- generations
    def refresh(self) -> int:
        """Adopt the newest committed generation (no-op while pinned).

        Returns the generation the scanner now serves; a long-lived caller
        (a query server) calls this between admission waves so a compaction
        commit invalidates its caches instead of silently serving a stale
        (or GC'd) layout.
        """
        if self._pin is not None:
            return self.generation
        snap = self.catalog.head_snapshot()
        if snap.generation != self.generation:
            manifest = snap.manifest
            index = DatasetIndex(manifest)
            self._views[snap.generation] = (manifest, index)
            self.generation = snap.generation
            self.manifest = manifest
            self.index = index
            self.extra_schema = dict(manifest.extra_schema)
            self.n_records = manifest.n_records
        return self.generation

    def _view(self, generation: int) -> tuple[DatasetManifest, DatasetIndex]:
        """(manifest, index) for one pinned generation (memoized)."""
        view = self._views.get(generation)
        if view is None:
            manifest = self.catalog.load_snapshot(generation).manifest
            view = (manifest, DatasetIndex(manifest))
            if len(self._views) > 8:  # old generations: drop the memo only
                self._views.clear()
                self._views[self.generation] = (self.manifest, self.index)
            self._views[generation] = view
        return view

    def close(self) -> None:
        """Release the lifetime pin (``pin_generation`` mode); idempotent."""
        if self._pin is not None:
            self._pin.release()
            self._pin = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- internals
    def _open_source(self, path: str):
        if self.source_factory is not None:
            return self.source_factory(path)
        return LocalFileSource(path)

    def _open_shard(self, path: str) -> SpatialParquetReader:
        return SpatialParquetReader(
            source=self._open_source(path),
            coalesce_max_gap=self.coalesce_max_gap,
            prefetch_row_groups=self.prefetch_row_groups,
            verify_checksums=self.verify_checksums)

    def open_shard(self, shard_i: int) -> SpatialParquetReader:
        """Open shard ``shard_i`` as a long-lived reader (caller closes).

        A query server keeps these open across queries so row-group decodes
        can be shared; one-shot scans should keep using :meth:`scan`, which
        owns its readers per call.
        """
        return self._open_shard(shard_path(self.root, self.manifest.shards[shard_i]))

    def _read_shard_once(self, path: str, bbox, columns, refine, coalesce,
                         device, keep_on_device, filter):
        src = self._open_source(path)
        try:
            with SpatialParquetReader(
                    source=src, coalesce_max_gap=self.coalesce_max_gap,
                    prefetch_row_groups=self.prefetch_row_groups,
                    verify_checksums=self.verify_checksums) as r:
                return r.read_columnar(
                    bbox=bbox, columns=columns, refine=refine,
                    coalesce=coalesce, device=device,
                    keep_on_device=keep_on_device, filter=filter,
                )
        except Exception as exc:
            # a failed attempt still did real I/O (and maybe retried,
            # timed out, hit the cache); hand its accrued SourceStats to
            # the caller so degraded scans keep the counters. Each attempt
            # gets a fresh source, so .stats IS the attempt's delta.
            exc.spqf_source_stats = src.stats.copy()
            raise

    def _read_shard(self, manifest: DatasetManifest, shard_i: int, bbox,
                    columns, refine, coalesce, device, keep_on_device,
                    filter):
        """Read one shard under the scanner's error policy.

        ``manifest`` is the scan's pinned snapshot — passed explicitly so a
        concurrent :meth:`refresh` can never mix two generations' shard
        lists inside one scan.

        Returns ``(result, extra_attempts, failure, failed_stats)`` where
        exactly one of ``result`` / ``failure`` is set and ``failed_stats``
        is the summed :class:`SourceStats` of every *failed* attempt (the
        successful attempt folds its own deltas inside ``read_columnar``);
        raises only under ``on_error="raise"`` (immediately) or ``"retry"``
        (after exhausting ``shard_retries``), always as an attributed
        :class:`ShardReadError`.
        """
        path = shard_path(self.root, manifest.shards[shard_i])
        retries = 0 if self.on_error == "raise" else self.shard_retries
        last: Exception | None = None
        failed = SourceStats()
        with obs.span("shard", shard=shard_i, path=path):
            for attempt in range(retries + 1):
                try:
                    res = self._read_shard_once(
                        path, bbox, columns, refine, coalesce, device,
                        keep_on_device, filter)
                    return res, attempt, None, failed
                except Exception as exc:
                    last = exc
                    partial = getattr(exc, "spqf_source_stats", None)
                    if partial is not None:
                        failed = failed + partial
                    obs.instant("shard.error", shard=shard_i,
                                attempt=attempt, error=type(exc).__name__)
        if self.on_error == "skip":
            obs.instant("shard.skip", shard=shard_i,
                        error=type(last).__name__)
            failure = ShardFailure.from_error(shard_i, path, last, retries + 1)
            return None, retries, failure, failed
        raise ShardReadError(shard_i, path, last) from last

    # -------------------------------------------------------------- scan API
    def scan(
        self,
        bbox=None,
        columns: tuple[str, ...] | None = None,
        refine: bool = False,
        parallel: bool = True,
        coalesce: bool = True,
        device: str = "cuda",
        *,
        keep_on_device: bool = False,
        filter=None,
    ) -> tuple[GeometryColumns | None, dict[str, np.ndarray], ReadStats]:
        """Dataset-wide ``read_columnar``: shard pruning + parallel fan-out.

        Same contract as the single-file reader, one level up; ``parallel=
        False`` forces a sequential shard loop (identical results, used by
        the equivalence tests). ``device="cuda"`` (the default) runs each
        shard's FP-delta page decode on the card (bit-identical results);
        with ``refine=True`` the bbox refinement follows the decode on the
        card so pruned records never reach the host, and with
        ``max_workers >= 2`` shard N's device work overlaps shard N+1's
        coalesced range reads, exactly like the host decode. ``"cpu"`` runs
        the plain versions on CPU tensors, ``"host"`` the numpy path.
        ``keep_on_device=True`` (``"cuda"`` or ``"cpu"``) returns
        coordinates merged across shards on that device.

        ``filter`` is an attribute predicate
        (:class:`~repro_torch.core.filters.Predicate`); shards whose manifest
        zone maps cannot match are pruned before their files are opened
        (counted in ``pruned.zone_bytes``), surviving shards apply the same
        predicate at page and record granularity, and results equal a full
        scan masked by the predicate row-by-row.

        With telemetry on (``repro_torch.obs.enable()``) the query runs inside a
        ``scan.dataset`` span with one ``shard`` child span per surviving
        shard (worker threads inherit the span context), and on return
        records the end-to-end latency histogram, the
        ``scan.host_cpu_s_per_gb`` histogram and the shard-level pruned-bytes
        counter. Telemetry off is the plain, allocation-identical path.
        """
        if device not in ("cuda", "cpu", "host"):
            raise ValueError(
                f"device must be 'cuda', 'cpu' or 'host', got {device!r}")
        if device != "host":
            torch_device(device)  # "cuda" without a card raises here
        elif keep_on_device:
            raise ValueError("keep_on_device=True requires device='cuda' or 'cpu'")
        if not obs.enabled():
            return self._scan_impl(bbox, columns, refine, parallel, coalesce,
                                   device, keep_on_device, filter)
        t0 = time.perf_counter()
        c0 = time.process_time()
        with obs.span("scan.dataset", root=self.root, device=device,
                      refine=bool(refine),
                      filtered=filter is not None) as sp:
            geo, extras, stats = self._scan_impl(
                bbox, columns, refine, parallel, coalesce, device,
                keep_on_device, filter)
            sp.add(shards_read=stats.shards_read,
                   records=stats.records_returned)
        wall = time.perf_counter() - t0
        cpu = time.process_time() - c0
        obs.observe("scan.dataset_latency_s", wall)
        scanned_gb = stats.bytes_read / 1e9
        if scanned_gb > 0:
            # the whole scan's value, beside those its shards' reads observe
            obs.observe("scan.host_cpu_s_per_gb", cpu / scanned_gb)
        return geo, extras, stats

    def _scan_impl(self, bbox, columns, refine, parallel, coalesce, device,
                   keep_on_device, filter=None):
        # every scan holds a pin on its generation for its whole duration:
        # a compaction commit + GC racing the scan cannot delete the shard
        # files this scan is reading. Unpinned scanners pin the *current
        # head* (resolved atomically inside pin()), not the generation last
        # seen by __init__/refresh() — a long-lived scanner keeps working
        # after a live compactor retires that remembered generation from
        # the retention window. Lifetime-pinned scanners reuse their pin.
        pin = self._pin
        release = pin is None
        if release:
            pin = self.catalog.pin()
        generation = pin.generation
        try:
            manifest, index = self._view(generation)
            return self._scan_pinned(
                manifest, index, bbox, columns, refine, parallel, coalesce,
                device, keep_on_device, filter)
        finally:
            if release:
                pin.release()

    def _scan_pinned(self, manifest, index, bbox, columns, refine, parallel,
                     coalesce, device, keep_on_device, filter=None):
        hit = index.query(bbox, filter=filter)
        hit_set = set(int(i) for i in hit)
        stats = ReadStats(shards_total=len(index), shards_read=len(hit))
        # pruned shards still count toward the totals (read side stays zero)
        pruned_bytes = 0
        for i, shard in enumerate(manifest.shards):
            if i not in hit_set:
                stats.pages_total += shard.n_pages
                stats.bytes_total += shard.data_bytes
                pruned_bytes += shard.data_bytes
        obs.count("pruned.shard_bytes", pruned_bytes)
        if filter is not None and obs.enabled():
            # shards inside the bbox that only the zone maps eliminated
            zoned = np.setdiff1d(index.query(bbox), hit, assume_unique=True)
            obs.count("pruned.zone_bytes", int(sum(
                manifest.shards[int(i)].data_bytes for i in zoned)))

        if len(hit) == 0:
            outcomes = []
        elif parallel and self.max_workers > 1 and len(hit) > 1:
            with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
                futures = [
                    obs.submit(pool, self._read_shard, manifest, int(i), bbox,
                               columns, refine, coalesce, device,
                               keep_on_device, filter)
                    for i in hit
                ]
                # gather in submission (manifest) order: deterministic output
                outcomes = [f.result() for f in futures]
        else:
            outcomes = [
                self._read_shard(manifest, int(i), bbox, columns, refine,
                                 coalesce, device, keep_on_device, filter)
                for i in hit
            ]

        # degraded-mode accounting: skipped shards leave the result but are
        # attributed in stats.failures; extra per-shard attempts accumulate,
        # and the partial SourceStats of every *failed* attempt fold into the
        # aggregate so retry/timeout/cache counters survive degraded scans
        results = []
        for res, attempts, failure, failed_src in outcomes:
            stats.shard_retries += attempts
            stats.retries += failed_src.retries
            stats.timeouts += failed_src.timeouts
            stats.cache_hits += failed_src.cache_hits
            stats.cache_misses += failed_src.cache_misses
            obs.fold_source_stats(failed_src, prefix="io.failed_attempts")
            if failure is not None:
                stats.failures.append(failure)
                stats.shards_read -= 1  # it never contributed bytes/records
            else:
                results.append(res)
        obs.count("read.shard_retries", stats.shard_retries)
        obs.count("read.shards_failed", len(stats.failures))
        obs.count("read.shards_total", stats.shards_total)
        obs.count("read.shards_read", stats.shards_read)

        geos = [g for g, _, _ in results if g is not None]
        # concat_columns merges TorchCoords shards on their device
        geo = concat_columns(geos) if geos else None
        extras: dict[str, np.ndarray] = {}
        if results:
            for k in results[0][1]:
                extras[k] = np.concatenate([ex[k] for _, ex, _ in results])
        stats = sum((st for _, _, st in results), stats)
        return geo, extras, stats

    def read_columnar(
        self,
        bbox=None,
        columns: tuple[str, ...] | None = None,
        refine: bool = False,
        coalesce: bool = True,
        device: str = "cuda",
        parallel: bool = True,
        *,
        keep_on_device: bool = False,
        filter=None,
    ):
        """Drop-in for :meth:`SpatialParquetReader.read_columnar` (same
        positional order; the extra ``parallel`` knob comes last,
        ``keep_on_device``/``filter`` are keyword-only everywhere)."""
        return self.scan(
            bbox=bbox, columns=columns, refine=refine,
            parallel=parallel, coalesce=coalesce, device=device,
            keep_on_device=keep_on_device, filter=filter,
        )

    def read(self, bbox=None, refine: bool = False) -> tuple[list[Geometry], ReadStats]:
        """Object-API read returning Geometry instances (like the reader's)."""
        geo, _, stats = self.scan(bbox=bbox, refine=refine)
        return (assemble(geo) if geo is not None else []), stats

    def shard_paths(self, bbox=None) -> list[str]:
        """Absolute paths of shards surviving bbox pruning, manifest order
        (the unit a training data pipeline stripes over)."""
        return [
            shard_path(self.root, self.manifest.shards[int(i)])
            for i in self.index.query(bbox)
        ]
