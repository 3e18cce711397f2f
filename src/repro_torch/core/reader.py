"""Spatial Parquet file reader: projection, range-filter pushdown, pruning.

The reader exposes two access paths:

* ``read(...)`` — the object API returning :class:`Geometry` lists (paper's
  reported read path), and
* ``read_columnar(...)`` — direct access to the decoded coordinate arrays.
  The paper (§5.1) names exactly this as the fix for its read-speed gap
  ("providing a lower-level access to the coordinate arrays from Parquet
  rather than reading one value at a time"); it is our primary fast path and
  what the training data pipeline consumes.

Coalesced-I/O architecture (the batched hot path)
-------------------------------------------------

``read_columnar`` never reads one page at a time. Per row group it collects
the ``(offset, nbytes)`` of every blob it needs — the four level streams,
each run of consecutive hit x/y pages (runs come straight from
``SpatialIndex.page_runs``, no Python-side grouping), and the matching extra
column pages — merges byte ranges whose gap is at most ``coalesce_max_gap``,
and issues exactly one ``seek`` + ``readinto`` per merged range into a
preallocated buffer. Individual blobs are then zero-copy ``memoryview``
slices of those buffers. For a full-file scan of one row group this is a
single read syscall for the whole group.

Row groups are **double-buffered** (``prefetch_row_groups``, default 1): a
single reader thread issues row group N+1's coalesced reads while the main
thread decodes row group N from already-filled buffers, so intra-file I/O
overlaps decode exactly like the dataset scanner overlaps shards. Results
are byte-identical to the sequential order (``prefetch_row_groups=0``
disables the overlap; ``coalesce=False`` implies it).

Decoding is allocation-lean to match: the total hit value count is known from
the index, so the x/y (and extra) destination arrays are preallocated once
and every page decodes straight into its slice via the ``out=`` contract of
``decode_page``/``fp_delta_decode`` — no per-page list-append or trailing
``np.concatenate`` over coordinates. Pass ``coalesce=False`` to force the
legacy one-read-per-blob behaviour (same decode path, used by the
equivalence tests).

Devices (``device="cuda"``, ``"cpu"``, ``"host"``)
---------------------------------------------------

``read_columnar(device="cuda")`` (the default) moves FP-delta decoding onto
the card: the host parses page headers (``fp_delta_plan``), then the
surviving coordinate pages of a row group are concatenated into page-stream
launches of hand-written CUDA kernels (``repro_torch.kernels.fp_delta``)
that resolve the escapes, gather the fixed-width tokens, inject the
escaped values and run the segmented cumsum and un-zigzag. ``device="cpu"``
runs the same torch chain with each kernel's plain version on CPU tensors;
``device="host"`` is the numpy path. Results are **bit-identical** across
the three; raw-encoded pages, level streams, and extra columns stay on the
host.

Fused device refinement (``refine=True`` on ``"cuda"`` or ``"cpu"``)
----------------------------------------------------------------------

With a bbox and ``refine=True``, refinement runs *where the data decodes*:
the decode is followed by the per-record order-key min/max and bbox
survivor test of ``repro_torch.kernels.minmax``
(``repro_torch.kernels.fp_delta.decode_refine_stream``). Pruned records
**never materialize on the host**: only the record mask and the surviving
coordinates cross back (raw-encoded pages join the launch through a
synthetic raw-mode plan, see ``pages.page_stream_plan``). The surviving
record set is bit-identical to the host refine. ``keep_on_device=True``
additionally leaves the surviving coordinates on the device, returning
:class:`~repro_torch.core.columnar.TorchCoords` columns.

Fault-tolerant storage boundary (``repro_torch.io``)
----------------------------------------------

The reader no longer touches a file handle directly: all I/O goes through a
:class:`~repro_torch.io.source.ByteRangeSource`. The default
:class:`~repro_torch.io.source.LocalFileSource` preserves the historical
``seek``+``readinto``-per-merged-run behaviour byte-for-byte; passing
``source=RemoteRangeSource(...)`` runs the identical read path against an
object-store-style backend with retries, deadlines and a read-through block
cache. Format-v2 files carry per-blob checksums which are verified on every
stored blob *before* it is decompressed, planned or launched (host and
device paths alike); a mismatch triggers one cache-bypassing re-fetch (which
heals a poisoned block cache) and raises an attributed
:class:`~repro_torch.io.checksum.ChecksumError` only if the bytes are still wrong.
All recoveries are counted in :class:`ReadStats` (``retries``, ``timeouts``,
``checksum_failures``, ``cache_hits``/``cache_misses``).
"""

from __future__ import annotations

import struct
import time
from bisect import bisect_right
from collections import deque
from dataclasses import dataclass, field
from dataclasses import replace as dc_replace

import msgpack
import numpy as np

from repro_torch import obs
from repro_torch._device import torch_device
from repro_torch.io.checksum import ChecksumError, checksum_fn, crc32c
from repro_torch.io.source import LocalFileSource

from .columnar import GeometryColumns, TorchCoords, assemble
from .filters import Predicate, canonical_bbox, validate_predicate
from .fp_delta import fp_delta_execute
from .geometry import Geometry
from .index import SpatialIndex
from .pages import (
    ENC_FP_DELTA,
    PageMeta,
    decode_page,
    decompress,
    page_stream_plan,
)
from .rle import decode_levels, rle_decode
from .writer import MAGIC, MAGIC_V2, permute_records

_LEVEL_NAMES = ("type", "type_rep", "rep", "defn")


def footer_data_bytes(footer: dict) -> int:
    """Total stored bytes of every blob (levels, coord pages, extras)."""
    total = 0
    for rg in footer["row_groups"]:
        total += sum(rg[name]["nbytes"] for name in _LEVEL_NAMES)
        total += sum(p["nbytes"] for p in rg["x_pages"])
        total += sum(p["nbytes"] for p in rg["y_pages"])
        for ep in rg.get("extra", {}).values():
            total += sum(p["nbytes"] for p in ep)
    return total


def footer_page_count(footer: dict) -> int:
    """Number of x/y page pairs (the unit of the per-page spatial index)."""
    return sum(len(rg["x_pages"]) for rg in footer["row_groups"])


@dataclass
class ReadStats:
    """Pruning accounting for the light-weight index (paper Figure 11).

    ``bytes_read``/``bytes_total`` count every stored blob (level streams,
    coordinate pages, extra-column pages) — not just x/y pages — so pruning
    ratios reflect what actually hits the disk.

    Stats are *mergeable*: ``a + b`` (or ``a.merge(b)``, or ``sum(stats)``)
    field-wise sums two accounts, so a multi-shard dataset scan reports one
    aggregate. ``shards_total``/``shards_read`` stay 0 for single-file reads
    and are filled in by the dataset scanner, where pruned shards contribute
    their page/byte totals but nothing to the ``*_read`` side.

    Recovery accounting (the fault-tolerant I/O layer): ``retries`` counts
    re-issued range requests (backoff retries inside a
    :class:`~repro_torch.io.remote.RemoteRangeSource` plus checksum-triggered blob
    re-fetches), ``timeouts`` the requests dropped for missing their
    deadline, ``checksum_failures`` every blob whose stored CRC mismatched
    (recovered or not), ``cache_hits``/``cache_misses`` the remote block
    cache, ``shard_retries`` scanner-level shard re-reads, and ``failures``
    the attributed record of shards a ``skip``-policy scan dropped (list of
    :class:`~repro_torch.dataset.errors.ShardFailure`).
    """

    pages_total: int = 0
    pages_read: int = 0
    bytes_total: int = 0
    bytes_read: int = 0
    records_scanned: int = 0
    records_returned: int = 0
    shards_total: int = 0
    shards_read: int = 0
    retries: int = 0
    timeouts: int = 0
    checksum_failures: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    shard_retries: int = 0
    failures: list = field(default_factory=list)

    @property
    def pages_skipped(self) -> int:
        return self.pages_total - self.pages_read

    @property
    def shards_skipped(self) -> int:
        return self.shards_total - self.shards_read

    @property
    def shards_failed(self) -> int:
        return len(self.failures)

    def merge(self, other: "ReadStats") -> "ReadStats":
        """Field-wise sum of two accounts (one aggregate per dataset scan)."""
        return ReadStats(
            pages_total=self.pages_total + other.pages_total,
            pages_read=self.pages_read + other.pages_read,
            bytes_total=self.bytes_total + other.bytes_total,
            bytes_read=self.bytes_read + other.bytes_read,
            records_scanned=self.records_scanned + other.records_scanned,
            records_returned=self.records_returned + other.records_returned,
            shards_total=self.shards_total + other.shards_total,
            shards_read=self.shards_read + other.shards_read,
            retries=self.retries + other.retries,
            timeouts=self.timeouts + other.timeouts,
            checksum_failures=self.checksum_failures + other.checksum_failures,
            cache_hits=self.cache_hits + other.cache_hits,
            cache_misses=self.cache_misses + other.cache_misses,
            shard_retries=self.shard_retries + other.shard_retries,
            failures=self.failures + other.failures,
        )

    def __add__(self, other):
        if not isinstance(other, ReadStats):
            return NotImplemented
        return self.merge(other)

    def __radd__(self, other):
        if other == 0:  # support sum(list_of_stats)
            return self
        return NotImplemented


class _CoalescedRanges:
    """Merge (offset, nbytes) requests and serve blobs from batched reads.

    One ``readinto_at`` per merged run — for a :class:`LocalFileSource` that
    is the historical single ``seek``+``readinto`` syscall pair, verbatim.
    """

    def __init__(self, source, ranges: list[tuple[int, int]], max_gap: int):
        spans = sorted(set(r for r in ranges if r[1] > 0))
        merged: list[list[int]] = []
        for off, nb in spans:
            if merged and off <= merged[-1][1] + max_gap:
                merged[-1][1] = max(merged[-1][1], off + nb)
            else:
                merged.append([off, off + nb])
        self._source = source
        self._starts = [m[0] for m in merged]
        self._bufs: list[memoryview] = []
        self.n_reads = 0
        for start, end in merged:
            buf = bytearray(end - start)
            got = source.readinto_at(start, buf)
            if got != len(buf):
                raise IOError("short read (truncated Spatial Parquet file)")
            self.n_reads += 1
            self._bufs.append(memoryview(buf))

    def blob(self, offset: int, nbytes: int) -> memoryview:
        i = bisect_right(self._starts, offset) - 1
        rel = offset - self._starts[i]
        return self._bufs[i][rel : rel + nbytes]

    def refetch(self, offset: int, nbytes: int) -> bytes:
        """Re-read one blob straight from storage, bypassing (and healing)
        any cache layer — the checksum-mismatch recovery path."""
        return self._source.read_at(offset, nbytes, refresh=True)


class _DirectRanges:
    """One read per blob (legacy path; kept for equivalence testing)."""

    def __init__(self, source):
        self._source = source

    def blob(self, offset: int, nbytes: int) -> bytes:
        return self._source.read_at(offset, nbytes)

    def refetch(self, offset: int, nbytes: int) -> bytes:
        return self._source.read_at(offset, nbytes, refresh=True)


@dataclass
class _RowGroupLevels:
    """Decoded level streams of one row group + record start indices.

    Owns the record-range slicing shared by the host and fused read loops,
    so the two paths can never drift apart on level semantics (their
    bit-identity is part of the fused-refine contract).
    """

    types: np.ndarray
    type_rep: np.ndarray
    rep: np.ndarray
    defn: np.ndarray
    slot_starts: np.ndarray
    type_starts: np.ndarray

    @property
    def n_rec(self) -> int:
        return len(self.slot_starts)

    def append_run(self, parts, r0: int, r1: int) -> None:
        """Slice records ``[r0, r1)`` into the four level part lists; the
        first slot of a run always starts a record, so the rep/type_rep
        heads are (re)pinned to 0."""
        types_parts, type_rep_parts, rep_parts, defn_parts = parts
        n_rec = self.n_rec
        s0 = self.slot_starts[r0]
        s1 = self.slot_starts[r1] if r1 < n_rec else len(self.rep)
        t0 = self.type_starts[r0]
        t1 = self.type_starts[r1] if r1 < n_rec else len(self.types)
        types_parts.append(self.types[t0:t1])
        tr = self.type_rep[t0:t1].copy()
        rp = self.rep[s0:s1].copy()
        tr[0] = 0
        rp[0] = 0
        type_rep_parts.append(tr)
        rep_parts.append(rp)
        defn_parts.append(self.defn[s0:s1])

    def record_value_counts(self) -> np.ndarray:
        """Values per record across the whole row group (pages are
        record-aligned, so hit runs slice out of this contiguously). Traced
        as the ``rg.value_counts`` span."""
        with (obs.span("rg.value_counts", cat="decode", slots=len(self.defn))
              if obs.enabled() else obs.NULL_SPAN):
            d64 = self.defn.astype(np.int64)
            value_idx = np.cumsum(d64) - d64
            total = int(value_idx[-1] + d64[-1]) if len(d64) else 0
            return np.diff(np.append(value_idx[self.slot_starts], total))


@dataclass
class RowGroupChunk:
    """One launch chunk of a fully read row group (``device="cuda"``/``"cpu"``).

    ``kind == "dev"`` carries an *unlaunched* page stream plus its refine aux
    (record segmentation): the query server launches it so it can answer a
    whole wave's bboxes from one decode. ``kind == "host"`` carries decoded
    x/y values of a page pair too large for any launch (decoded on the host,
    same bits). ``rec_lo``/``rec_hi`` are the rg-local record range the chunk
    covers.
    """

    kind: str
    rec_lo: int
    rec_hi: int
    stream: object = None
    aux: object = None
    x: np.ndarray | None = None
    y: np.ndarray | None = None


@dataclass
class RowGroupData:
    """Every page of one row group, read once (see ``read_row_group``).

    ``extras`` holds the full extra-column arrays (length ``n_records``);
    ``nbytes`` is the stored bytes fetched to build this (levels + extras +
    x/y pages) — the cache-attribution unit. Exactly one of ``x``/``y``
    (``device="host"``) or ``chunks`` (``"cuda"``/``"cpu"``) is populated.
    """

    rg_i: int
    n_records: int
    rec_vcounts: np.ndarray
    levels: _RowGroupLevels
    extras: dict
    nbytes: int
    x: np.ndarray | None = None
    y: np.ndarray | None = None
    chunks: list[RowGroupChunk] | None = None


class SpatialParquetReader:
    """Reader over one ``.spqf`` object.

    ``path`` opens a :class:`~repro_torch.io.source.LocalFileSource`; pass
    ``source=`` instead (e.g. a :class:`~repro_torch.io.remote.RemoteRangeSource`)
    to read the same bytes from elsewhere — the reader owns whichever source
    it ends up with and closes it. ``verify_checksums=False`` skips the v2
    integrity checks (v1 files carry none and are never verified). The open
    (the source, the footer and its checksum, the index) is traced as the
    ``reader.open`` span.
    """

    def __init__(self, path=None, *, source=None, coalesce_max_gap: int = 1 << 16,
                 prefetch_row_groups: int = 1, verify_checksums: bool = True):
        with obs.span("reader.open", cat="io") if obs.enabled() else obs.NULL_SPAN:
            if source is None:
                if path is None:
                    raise ValueError("SpatialParquetReader needs a path or a source")
                source = LocalFileSource(path)
            self.path = str(path) if path is not None else getattr(
                source, "path", "<source>")
            self.coalesce_max_gap = int(coalesce_max_gap)
            self.prefetch_row_groups = max(0, int(prefetch_row_groups))
            self._source = source
            self._closed = False
            try:
                self.footer = self._read_footer()
                self.coord_dtype = np.dtype(self.footer["coord_dtype"])
                self.codec = self.footer["codec"]
                self.n_records = self.footer["n_records"]
                self.extra_schema = self.footer.get("extra_schema", {})
                self.checksum_algo = self.footer.get("checksum_algo")
                self._verify = bool(verify_checksums) and self.checksum_algo is not None
                self._blob_crc = checksum_fn(self.checksum_algo) if self._verify else None
                self.index = SpatialIndex(self.footer)
                self._data_bytes = self._total_data_bytes()
            except Exception:
                # never leak the handle/source when construction fails mid-way
                self.close()
                raise

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self):
        if not self._closed:
            self._closed = True
            self._source.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- internals
    def _read_footer(self) -> dict:
        src = self._source
        size = src.size()
        if size < 2 * len(MAGIC) + 4:
            raise ValueError("truncated Spatial Parquet file (too short)")
        lead = src.read_at(0, len(MAGIC))
        if lead not in (MAGIC, MAGIC_V2):
            raise ValueError("not a Spatial Parquet file (bad leading magic)")
        tail = src.read_at(size - len(MAGIC) - 4, len(MAGIC) + 4)
        (flen,) = struct.unpack("<I", tail[:4])
        trail = tail[4:]
        if trail not in (MAGIC, MAGIC_V2):
            raise ValueError("truncated Spatial Parquet file (bad trailing magic)")
        if flen > size - 2 * len(MAGIC) - 4:
            raise ValueError("truncated Spatial Parquet file (bad footer length)")
        stored = src.read_at(size - len(MAGIC) - 4 - flen, flen)
        if trail == MAGIC_V2:
            # v2 trailer: [footer][crc32c(footer): u32]; verify before unpack
            # so a corrupt footer never feeds garbage to msgpack / the index
            blob, crc_bytes = stored[:-4], stored[-4:]
            (want,) = struct.unpack("<I", crc_bytes)
            got = crc32c(blob)
            if got != want:
                raise ChecksumError("file footer", size - len(MAGIC) - 4 - flen,
                                    len(blob), want, got)
        else:
            blob = stored
        return msgpack.unpackb(blob, raw=False, strict_map_key=False)

    def _checked_blob(self, src, offset: int, nbytes: int,
                      crc: int | None, stats: ReadStats, what: str):
        """Fetch one stored blob, verifying its v2 checksum when present.

        A mismatch triggers exactly one cache-bypassing re-fetch (healing a
        poisoned remote block cache); if the fresh bytes still mismatch, the
        blob is genuinely corrupt and an attributed ChecksumError raises
        *before* any decompress/decode/launch consumes it.
        """
        blob = src.blob(offset, nbytes)
        if not self._verify or crc is None:
            return blob
        with (obs.span("rg.checksum", cat="io", bytes=nbytes)
              if obs.enabled() else obs.NULL_SPAN):
            got = self._blob_crc(blob)
        if got == crc:
            return blob
        stats.checksum_failures += 1
        obs.instant("checksum.refetch", cat="io", what=what, offset=offset)
        fresh = src.refetch(offset, nbytes)
        stats.retries += 1
        got = self._blob_crc(fresh)
        if got == crc and len(fresh) == nbytes:
            return fresh
        raise ChecksumError(what, offset, nbytes, crc, got)

    def _total_data_bytes(self) -> int:
        return footer_data_bytes(self.footer)

    def _rg_ranges(self, rg, runs, base, want_geom, extra_pages):
        """Every byte range one row group's decode needs (metadata only)."""
        idx = self.index
        ranges: list[tuple[int, int]] = []
        if want_geom:
            ranges += [
                (rg[name]["offset"], rg[name]["nbytes"]) for name in _LEVEL_NAMES
            ]
        for p0, p1 in runs:
            if want_geom:
                j0, j1 = base + p0, base + p1 - 1
                ranges.append((
                    int(idx.x_offset[j0]),
                    int(idx.x_offset[j1] + idx.x_nbytes[j1] - idx.x_offset[j0]),
                ))
                ranges.append((
                    int(idx.y_offset[j0]),
                    int(idx.y_offset[j1] + idx.y_nbytes[j1] - idx.y_offset[j0]),
                ))
            for ep in extra_pages.values():
                first, last = ep[p0], ep[p1 - 1]
                ranges.append((
                    first["offset"],
                    last["offset"] + last["nbytes"] - first["offset"],
                ))
        return ranges

    def _level_blob(self, src, rg, name: str, stats: ReadStats):
        meta = rg[name]
        return self._checked_blob(src, meta["offset"], meta["nbytes"],
                                  meta.get("crc"), stats,
                                  f"{name!r} level stream")

    def _decode_rg_levels(self, src, rg, stats: ReadStats) -> _RowGroupLevels:
        """Decode one row group's four level streams from memory slices."""
        with obs.span("rg.levels", cat="decode") as sp:
            lv = self._decode_rg_levels_inner(src, rg, stats)
            sp.add(slots=len(lv.rep))
            return lv

    def _decode_rg_levels_inner(self, src, rg, stats: ReadStats) -> _RowGroupLevels:
        types = rle_decode(
            decompress(self._level_blob(src, rg, "type", stats), self.codec))
        type_rep = decode_levels(
            decompress(self._level_blob(src, rg, "type_rep", stats), self.codec))
        rep = decode_levels(
            decompress(self._level_blob(src, rg, "rep", stats), self.codec))
        defn = decode_levels(
            decompress(self._level_blob(src, rg, "defn", stats), self.codec))
        stats.bytes_read += sum(rg[name]["nbytes"] for name in _LEVEL_NAMES)
        return _RowGroupLevels(types, type_rep, rep, defn,
                               np.flatnonzero(rep == 0),
                               np.flatnonzero(type_rep == 0))

    def _decode_run_extras(self, src, extra_pages, extra_all, we: int,
                           p0: int, p1: int, stats: ReadStats) -> None:
        """Decode one run's extra-column pages into the preallocated columns
        at record cursor ``we`` (the ``rg.extras`` span)."""
        if not extra_pages:
            return
        with (obs.span("rg.extras", cat="decode", columns=len(extra_pages), pages=p1 - p0)
              if obs.enabled() else obs.NULL_SPAN):
            for k, ep in extra_pages.items():
                wk = we
                for p in range(p0, p1):
                    meta = PageMeta.from_dict(ep[p])
                    blob = self._checked_blob(
                        src, meta.offset, meta.nbytes, meta.crc, stats,
                        f"extra column {k!r} page {p}")
                    decode_page(
                        blob, meta,
                        np.dtype(self.extra_schema[k]), self.codec,
                        out=extra_all[k][wk : wk + meta.count],
                    )
                    stats.bytes_read += meta.nbytes
                    wk += meta.count

    def _iter_sources(self, items, coalesce: bool):
        """Yield ``(item, src)`` per hit row group, double-buffering reads.

        With coalescing on and ``prefetch_row_groups >= 1``, a single worker
        thread runs row group N+1's ``readinto`` calls while the caller
        decodes row group N (file I/O releases the GIL; the main thread only
        touches prefilled buffers, never the source). Yields in file order,
        so results are byte-identical to the sequential path.

        The read loops close this generator in a ``finally`` (triggering
        ``GeneratorExit`` here), so the pool's ``with`` block always joins
        the prefetch thread — including when a decode raises mid-row-group.
        """
        if not coalesce:
            for it in items:
                yield it, _DirectRanges(self._source)
            return

        def fetch(it):
            # the "fetch" stage span: every readinto of one row group's
            # coalesced ranges (runs on the prefetch thread when enabled —
            # obs.submit hands the span context across)
            with obs.span("rg.fetch", cat="io", rg=it[0]):
                return _CoalescedRanges(self._source, it[-1],
                                        self.coalesce_max_gap)

        lookahead = self.prefetch_row_groups
        if lookahead == 0 or len(items) <= 1:
            for it in items:
                yield it, fetch(it)
            return
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=1) as pool:
            pending: deque = deque()
            nxt = 0
            while nxt < len(items) and len(pending) < lookahead:
                pending.append(obs.submit(pool, fetch, items[nxt]))
                nxt += 1
            for it in items:
                # the client blocks here on the prefetch thread's rg.fetch
                with (obs.span("rg.wait", cat="io", rg=it[0])
                      if obs.enabled() else obs.NULL_SPAN):
                    src = pending.popleft().result()
                if nxt < len(items):
                    pending.append(obs.submit(pool, fetch, items[nxt]))
                    nxt += 1
                yield it, src

    # -------------------------------------------------------------- read API
    def read_columnar(
        self,
        bbox=None,
        columns: tuple[str, ...] | None = None,
        refine: bool = False,
        coalesce: bool = True,
        device: str = "cuda",
        *,
        keep_on_device: bool = False,
        filter: Predicate | None = None,
    ) -> tuple[GeometryColumns | None, dict[str, np.ndarray], ReadStats]:
        """Decode records whose *page* bbox intersects ``bbox``.

        Returns (geometry columns, extra columns, stats). ``refine=True``
        additionally drops records whose exact bbox misses the query.
        ``columns`` restricts which extra columns decode ("geometry" is
        implied unless columns excludes it explicitly). ``filter`` is a
        :mod:`repro_torch.core.filters` predicate over extra columns: pages whose
        zone statistics prove no match are skipped, and the surviving
        records are filtered *exactly* (the result is always identical to
        reading without zone pruning and masking afterwards — the record
        mask is ``bbox ∧ attrs`` when combined with ``refine``). Columns a
        filter needs are decoded as required but only returned when
        requested. ``coalesce=False``
        disables batched range I/O (one read per blob; identical results).
        ``device="cuda"`` (the default) decodes surviving FP-delta
        coordinate pages on the card with the CUDA kernels (bit-identical
        results); combined with ``refine=True`` the per-record bbox test
        also runs on the card and only surviving records transfer back.
        ``device="cpu"`` runs the same torch chain with the kernels' plain
        versions on CPU tensors; ``device="host"`` is the numpy path and the
        oracle. ``keep_on_device=True`` (``"cuda"`` or ``"cpu"``) returns
        :class:`TorchCoords` coordinate columns that stay on that device;
        it is a no-op when ``columns`` excludes geometry (extra columns
        always decode on the host).

        With telemetry on (``repro_torch.obs.enable()``) the call is wrapped in a
        ``scan.file`` span with child spans for the index (``scan.index``),
        each row group's wait on the prefetch thread, planning, launches and
        gather, and the assembly of the result (``scan.assemble``), and on
        return folds its ``ReadStats`` and the histograms ``scan.latency_s``
        and ``scan.host_cpu_s_per_gb`` and the bytes pruned per level into
        the metrics registry. Disabled, the path is allocation- and
        result-identical to the uninstrumented one.
        """
        if not obs.enabled():
            return self._read_columnar_impl(
                bbox, columns, refine, coalesce, device,
                keep_on_device=keep_on_device, filter=filter)
        t0 = time.perf_counter()
        c0 = time.process_time()
        with obs.span("scan.file", path=self.path, device=device,
                      refine=bool(refine), filtered=filter is not None):
            out = self._read_columnar_impl(
                bbox, columns, refine, coalesce, device,
                keep_on_device=keep_on_device, filter=filter)
        wall = time.perf_counter() - t0
        cpu = time.process_time() - c0
        stats = out[2]
        obs.observe("scan.latency_s", wall)
        scanned_gb = stats.bytes_read / 1e9
        if scanned_gb > 0:
            # process-wide CPU per scanned GB: the GPU-layout-v2 ROADMAP
            # metric (how much host planning/decode a scan still costs)
            obs.observe("scan.host_cpu_s_per_gb", cpu / scanned_gb)
        obs.count("pruned.page_bytes",
                  max(0, stats.bytes_total - stats.bytes_read))
        obs.fold_read_stats(stats)
        return out

    def _read_columnar_impl(self, bbox, columns, refine, coalesce, device,
                            *, keep_on_device, filter=None):
        if device not in ("cuda", "cpu", "host"):
            raise ValueError(
                f"device must be 'cuda', 'cpu' or 'host', got {device!r}")
        use_device = device != "host"
        if use_device:
            torch_device(device)  # "cuda" without a card raises here
        if keep_on_device and not use_device:
            raise ValueError("keep_on_device=True requires device='cuda' or 'cpu'")
        if filter is not None:
            validate_predicate(filter, self.extra_schema)
        want_geom = columns is None or "geometry" in columns
        want_extra = (
            list(self.extra_schema)
            if columns is None
            else [c for c in columns if c in self.extra_schema]
        )
        # columns the filter needs decode too, but are only *returned* when
        # requested (trimmed below)
        read_extra = list(want_extra)
        if filter is not None:
            read_extra += [c for c in sorted(filter.columns())
                           if c not in want_extra]
        idx = self.index
        stats = ReadStats(pages_total=len(idx), bytes_total=self._data_bytes)
        src_stats0 = self._source.stats.copy()

        with obs.span("scan.index", cat="plan") if obs.enabled() else obs.NULL_SPAN:
            # group hit-page runs by row group (runs arrive in file order)
            hit = idx.query(bbox, filter=filter)
            if filter is not None and obs.enabled():
                # coordinate bytes of pages the zone stats pruned beyond bbox
                zoned = np.setdiff1d(idx.query(bbox), hit, assume_unique=True)
                obs.count("pruned.zone_bytes", int(idx.nbytes[zoned].sum()))
            runs_by_rg: dict[int, list[tuple[int, int]]] = {}
            for rg_i, p0, p1 in idx.page_runs(bbox, hit=hit):
                runs_by_rg.setdefault(rg_i, []).append((p0, p1))
                stats.pages_read += p1 - p0

            # per-row-group work items: (rg_i, rg, runs, base, extra_pages, ranges)
            items = []
            for rg_i, rg in enumerate(self.footer["row_groups"]):
                runs = runs_by_rg.get(rg_i)
                if not runs:
                    continue
                base = int(np.searchsorted(idx.row_group, rg_i, side="left"))
                extra_pages = {k: rg["extra"][k] for k in read_extra}
                items.append((rg_i, rg, runs, base, extra_pages,
                              self._rg_ranges(rg, runs, base, want_geom, extra_pages)))

        fused = use_device and want_geom and (
            keep_on_device or (refine and bbox is not None)
            or (filter is not None and self.coord_dtype.kind == "f")
        )
        if fused and refine and bbox is not None and self.coord_dtype.kind != "f":
            if keep_on_device:
                raise ValueError("device refinement requires float coordinates")
            fused = False  # exotic int coords: decode on device, refine on host
        if fused:
            out = self._read_columnar_fused(
                bbox, refine, coalesce, keep_on_device, read_extra,
                items, stats, hit, device, filter=filter)
            if filter is not None:
                geo_f, extras_f, stats_f = out
                out = (geo_f, {k: extras_f[k] for k in want_extra}, stats_f)
            self._fold_source_stats(stats, src_stats0)
            return out

        if use_device:
            from repro_torch.kernels.fp_delta import decode_pages as _device_decode_pages

        # preallocate coordinate destinations across every hit page
        total_vals = int(idx.count[hit].sum()) if len(hit) else 0
        x_all = np.empty(total_vals, self.coord_dtype) if want_geom else None
        y_all = np.empty(total_vals, self.coord_dtype) if want_geom else None
        total_recs = int(idx.rec_count[hit].sum()) if len(hit) else 0
        extra_all = {
            k: np.empty(total_recs, np.dtype(self.extra_schema[k]))
            for k in read_extra
        }

        types_parts: list[np.ndarray] = []
        type_rep_parts: list[np.ndarray] = []
        rep_parts: list[np.ndarray] = []
        defn_parts: list[np.ndarray] = []
        w = 0   # value write cursor into x_all / y_all
        we = 0  # record write cursor into extra columns
        level_parts = (types_parts, type_rep_parts, rep_parts, defn_parts)
        src_iter = self._iter_sources(items, coalesce)
        try:
            for (rg_i, rg, runs, base, extra_pages, _ranges), src in src_iter:
                xp, yp = rg["x_pages"], rg["y_pages"]
                if want_geom:
                    lv = self._decode_rg_levels(src, rg, stats)

                deferred: list[tuple] = []  # (plan, dest array, dest offset)

                def _coord_page(axis, page_dict, j, p, dest, off, cnt):
                    """Decode one coordinate page now (host) or defer it to
                    the row group's batched device launch (fp_delta only)."""
                    meta = PageMeta.from_dict(page_dict)
                    blob = self._checked_blob(
                        src,
                        int(idx.x_offset[j] if axis == "x" else idx.y_offset[j]),
                        int(idx.x_nbytes[j] if axis == "x" else idx.y_nbytes[j]),
                        meta.crc, stats,
                        f"{axis} page {p} of row group {rg_i}")
                    if use_device and meta.encoding == ENC_FP_DELTA:
                        deferred.append(
                            (page_stream_plan(blob, meta, self.coord_dtype, self.codec),
                             dest, off))
                    else:
                        decode_page(blob, meta, self.coord_dtype, self.codec,
                                    out=dest[off : off + cnt])

                with obs.span("rg.decode", cat="decode", rg=rg_i,
                              device=device):
                    for p0, p1 in runs:
                        j0, j1 = base + p0, base + p1 - 1
                        r0 = int(idx.rec_start[j0])
                        r1 = int(idx.rec_start[j1] + idx.rec_count[j1])
                        stats.records_scanned += r1 - r0
                        if want_geom:
                            for p in range(p0, p1):
                                j = base + p
                                cnt = int(idx.count[j])
                                _coord_page("x", xp[p], j, p, x_all, w, cnt)
                                _coord_page("y", yp[p], j, p, y_all, w, cnt)
                                w += cnt
                            stats.bytes_read += int(
                                idx.x_nbytes[j0 : j1 + 1].sum()
                                + idx.y_nbytes[j0 : j1 + 1].sum()
                            )
                            lv.append_run(level_parts, r0, r1)
                        self._decode_run_extras(src, extra_pages, extra_all,
                                                we, p0, p1, stats)
                        we += r1 - r0

                if deferred:
                    # one batched page-stream launch per row group; decoded
                    # bits are copied into the preallocated columns dtype-
                    # blind (view) so float/int columns both stay bit-exact
                    with obs.span("rg.launch", cat="device", rg=rg_i,
                                  pages=len(deferred)):
                        outs = _device_decode_pages([p for p, _, _ in deferred],
                                                    device=device)
                        for (plan, dest, off), vals in zip(deferred, outs):
                            dest[off : off + plan.n_values] = vals.view(dest.dtype)
        finally:
            src_iter.close()

        with obs.span("scan.assemble", cat="decode") if obs.enabled() else obs.NULL_SPAN:
            if want_geom and types_parts:
                geo = GeometryColumns(
                    np.concatenate(types_parts),
                    np.concatenate(type_rep_parts),
                    np.concatenate(rep_parts),
                    np.concatenate(defn_parts),
                    x_all[:w], y_all[:w],
                )
            else:
                geo = None
            extras = {k: v[:we] for k, v in extra_all.items()}
            keep_mask = None
            if refine and bbox is not None and geo is not None:
                with obs.span("refine.host", cat="refine"):
                    starts = geo.record_value_starts()
                    counts = np.diff(np.append(starts, geo.n_values))
                    keep_mask = _bbox_keep_mask(geo.x, geo.y, counts, bbox)
            if filter is not None:
                attr = (filter.mask(extras) if we
                        else np.zeros(0, bool))
                if we:
                    obs.observe("filter.selectivity", float(attr.sum()) / we)
                keep_mask = attr if keep_mask is None else keep_mask & attr
            if keep_mask is not None:
                if geo is not None:
                    geo = permute_records(geo, np.flatnonzero(keep_mask))
                    obs.count("pruned.record_bytes",
                              (w - geo.n_values) * 2 * self.coord_dtype.itemsize)
                extras = {k: v[keep_mask] for k, v in extras.items()}
            if filter is not None:
                extras = {k: extras[k] for k in want_extra}
            stats.records_returned = geo.n_records if geo is not None else (
                len(next(iter(extras.values()))) if extras else 0
            )
        self._fold_source_stats(stats, src_stats0)
        return geo, extras, stats

    def _fold_source_stats(self, stats: ReadStats, before) -> None:
        """Fold the source's recovery counters accrued by this read into the
        query's ReadStats (delta against the snapshot taken at entry)."""
        d = self._source.stats - before
        stats.retries += d.retries
        stats.timeouts += d.timeouts
        stats.cache_hits += d.cache_hits
        stats.cache_misses += d.cache_misses

    # ------------------------------------------------------ fused device scan
    def _read_columnar_fused(self, bbox, refine, coalesce, keep_on_device,
                             want_extra, items, stats, hit, device, filter=None):
        """Decode → per-record bbox refine → compact, all device-resident.

        Per row group: levels decode on the host (they drive segmentation),
        every hit coordinate page becomes a plan (raw pages via the synthetic
        raw-mode plan) and joins one fused launch chain per launch-cap-sized
        chunk (`decode_refine_stream`) on ``device``. Only the per-record survivor mask and the
        surviving coordinate values cross back to the host — or nothing at
        all with ``keep_on_device=True``.

        With ``filter`` the host-evaluated attribute mask is AND-ed into the
        chunk's per-record ``valid`` operand before the launch, so the device
        computes ``bbox ∧ attrs`` in one pass and survivor compaction (the
        gather back to the host) already excludes records the predicate
        rejects.
        """
        from repro_torch.kernels.fp_delta import (
            build_page_stream,
            build_refine_aux,
            check_escapes,
            chunk_plan_pairs,
            decode_refine_stream,
            decode_stream_bits,
            gather_stream_values,
            ragged_ranges,
            stream_from_numpy,
        )

        idx = self.index
        dtype = self.coord_dtype
        do_refine = refine and bbox is not None
        do_compact = do_refine or filter is not None

        total_recs = int(idx.rec_count[hit].sum()) if len(hit) else 0
        extra_all = {
            k: np.empty(total_recs, np.dtype(self.extra_schema[k]))
            for k in want_extra
        }
        types_parts: list[np.ndarray] = []
        type_rep_parts: list[np.ndarray] = []
        rep_parts: list[np.ndarray] = []
        defn_parts: list[np.ndarray] = []
        keep_parts: list[np.ndarray] = []
        x_parts: list = []
        y_parts: list = []
        we = 0

        level_parts = (types_parts, type_rep_parts, rep_parts, defn_parts)
        vals_pruned = 0  # refine-dropped values (record-level byte pruning)
        unchecked: list = []  # decoded streams whose escape check is pending
        src_iter = self._iter_sources(items, coalesce)
        try:
            for (rg_i, rg, runs, base, extra_pages, _ranges), src in src_iter:
                xp, yp = rg["x_pages"], rg["y_pages"]
                lv = self._decode_rg_levels(src, rg, stats)
                rec_vcounts_rg = lv.record_value_counts()
                we0 = we  # this row group's record span in the extra columns

                plans: list = []            # x,y plan per page, stream order
                pairs: list[tuple[int, int]] = []   # local record range per pair
                vc_parts: list[np.ndarray] = []
                local_base = 0
                plan_span = obs.span("rg.plan", cat="plan", rg=rg_i)
                with plan_span:
                    for p0, p1 in runs:
                        j0, j1 = base + p0, base + p1 - 1
                        r0 = int(idx.rec_start[j0])
                        r1 = int(idx.rec_start[j1] + idx.rec_count[j1])
                        stats.records_scanned += r1 - r0
                        for p in range(p0, p1):
                            j = base + p
                            meta_x = PageMeta.from_dict(xp[p])
                            meta_y = PageMeta.from_dict(yp[p])
                            # checksums gate the launch chain: a corrupt page
                            # is caught here, before any plan or kernel
                            # sees it
                            blob_x = self._checked_blob(
                                src, int(idx.x_offset[j]), int(idx.x_nbytes[j]),
                                meta_x.crc, stats,
                                f"x page {p} of row group {rg_i}")
                            blob_y = self._checked_blob(
                                src, int(idx.y_offset[j]), int(idx.y_nbytes[j]),
                                meta_y.crc, stats,
                                f"y page {p} of row group {rg_i}")
                            plans.append(page_stream_plan(
                                blob_x, meta_x, dtype, self.codec))
                            plans.append(page_stream_plan(
                                blob_y, meta_y, dtype, self.codec))
                            lo_loc = local_base + int(idx.rec_start[j]) - r0
                            pairs.append((lo_loc, lo_loc + int(idx.rec_count[j])))
                        stats.bytes_read += int(
                            idx.x_nbytes[j0 : j1 + 1].sum() + idx.y_nbytes[j0 : j1 + 1].sum()
                        )
                        vc_parts.append(rec_vcounts_rg[r0:r1])
                        local_base += r1 - r0
                        lv.append_run(level_parts, r0, r1)
                        self._decode_run_extras(src, extra_pages, extra_all, we,
                                                p0, p1, stats)
                        we += r1 - r0
                    plan_span.add(pages=len(pairs))
                rec_vcounts = (np.concatenate(vc_parts) if vc_parts
                               else np.zeros(0, np.int64))
                # host-evaluated attribute mask for this row group's read
                # records (aligned with rec_vcounts / the chunk record ranges)
                attr_rg = None
                if filter is not None:
                    attr_rg = filter.mask(
                        {k: extra_all[k][we0:we] for k in filter.columns()})

                # chunk page pairs into fused launches under the cap
                for kind, cplans, cpairs, (rl, rh) in chunk_plan_pairs(plans, pairs):
                    vc = rec_vcounts[rl:rh]
                    attr_c = attr_rg[rl:rh] if attr_rg is not None else None
                    if kind == "host":
                        # a single page too large for any launch: decode this
                        # pair on the host (same bits via fp_delta_execute)
                        with obs.span("rg.launch", cat="decode", rg=rg_i,
                                      kind="host"):
                            x_v = fp_delta_execute(cplans[0])
                            y_v = fp_delta_execute(cplans[1])
                            keep_c = (_bbox_keep_mask(x_v, y_v, vc, bbox)
                                      if do_refine else np.ones(len(vc), bool))
                            if attr_c is not None:
                                keep_c = keep_c & attr_c
                            starts = np.cumsum(vc) - vc
                            iv = ragged_ranges(starts[keep_c], vc[keep_c])
                            xs, ys = x_v[iv], y_v[iv]
                        if keep_on_device:
                            xs = TorchCoords.from_numpy(xs, device)
                            ys = TorchCoords.from_numpy(ys, device)
                        if do_compact and obs.enabled():
                            vals_pruned += int(vc.sum() - vc[keep_c].sum())
                        keep_parts.append(keep_c)
                        x_parts.append(xs)
                        y_parts.append(ys)
                        continue
                    with obs.span("rg.launch", cat="device", rg=rg_i,
                                  kind="refine" if do_refine else "decode",
                                  pairs=len(cpairs)):
                        stream = build_page_stream(cplans)
                        aux = build_refine_aux(
                            stream, [(a - rl, b - rl) for a, b in cpairs], vc)
                        if attr_c is not None and do_refine:
                            # the device record mask is valid ∧ bbox; AND-ing
                            # the attribute mask into a fresh copy of valid
                            # makes it bbox ∧ attrs in the same launch
                            v2 = aux.valid.copy()
                            v2[:len(attr_c)] &= attr_c
                            aux = dc_replace(aux, valid=v2)
                        if do_refine:
                            res = decode_refine_stream(stream, aux, bbox,
                                                       device=device)
                            keep_c, bits_d = res.keep, res.bits
                        else:
                            ds = stream_from_numpy(stream, device=device)
                            bits_d = decode_stream_bits(ds)
                            unchecked.append(ds)
                            keep_c = (attr_c.copy() if attr_c is not None
                                      else np.ones(len(vc), bool))
                    if do_compact and obs.enabled():
                        vals_pruned += int(vc.sum() - vc[keep_c].sum())
                    keep_parts.append(keep_c)
                    with obs.span("rg.gather", cat="transfer", rg=rg_i):
                        ix = ragged_ranges(aux.x_start[keep_c], aux.counts[keep_c])
                        iy = ragged_ranges(aux.y_start[keep_c], aux.counts[keep_c])
                        x_parts.append(gather_stream_values(
                            bits_d, ix, dtype, keep_on_device=keep_on_device))
                        y_parts.append(gather_stream_values(
                            bits_d, iy, dtype, keep_on_device=keep_on_device))
        finally:
            src_iter.close()
        # streams decoded without a refine are checked once, here (after the
        # gathers' transfers, or, kept on the device, the read's one wait)
        check_escapes(unchecked)
        obs.count("pruned.record_bytes", vals_pruned * 2 * dtype.itemsize)

        with obs.span("scan.assemble", cat="decode") if obs.enabled() else obs.NULL_SPAN:
            keep_all = (np.concatenate(keep_parts) if keep_parts
                        else np.zeros(0, bool))
            if types_parts:
                types = np.concatenate(types_parts)
                type_rep = np.concatenate(type_rep_parts)
                rep = np.concatenate(rep_parts)
                defn = np.concatenate(defn_parts)
                if do_compact:
                    # record-aligned level subset == permute_records on the kept
                    # (sorted) records: canonical levels stay canonical
                    slot_keep = keep_all[np.cumsum(rep == 0) - 1]
                    type_keep = keep_all[np.cumsum(type_rep == 0) - 1]
                    types = types[type_keep]
                    type_rep = type_rep[type_keep]
                    rep = rep[slot_keep]
                    defn = defn[slot_keep]
                if keep_on_device:
                    x = TorchCoords.concat(x_parts)
                    y = TorchCoords.concat(y_parts)
                else:
                    x = np.concatenate(x_parts)
                    y = np.concatenate(y_parts)
                geo = GeometryColumns(types, type_rep, rep, defn, x, y)
            else:
                geo = None
            extras = {k: v[:we] for k, v in extra_all.items()}
            if do_compact and geo is not None:
                extras = {k: v[keep_all] for k, v in extras.items()}
            if filter is not None and we:
                obs.observe("filter.selectivity", float(keep_all.sum()) / we)
            stats.records_returned = geo.n_records if geo is not None else (
                len(next(iter(extras.values()))) if extras else 0
            )
        return geo, extras, stats

    # ---------------------------------------------- whole-row-group decode
    def read_row_group(self, rg_i: int, *, columns=None,
                       device: str = "cuda") -> "RowGroupData":
        """Fetch *every* page of one row group, independent of any query
        bbox — the unit of the query server's decoded-row-group cache
        (:mod:`repro_torch.serve.query_scheduler`).

        Pages are record-aligned, so a record's values (and therefore its
        exact [min, max]) computed from the full row group are bit-identical
        to the same record decoded through a bbox-pruned page run — the
        property that lets one decode serve queries whose page sets differ.
        ``device="host"`` decodes into ``x``/``y`` numpy arrays;
        ``device="cuda"`` (the default) or ``"cpu"`` returns *unlaunched*
        per-chunk page streams (the caller owns the launch so it can answer
        many bboxes from one decode).
        """
        if device not in ("cuda", "cpu", "host"):
            raise ValueError(
                f"device must be 'cuda', 'cpu' or 'host', got {device!r}")
        if device != "host":
            torch_device(device)  # "cuda" without a card raises here
        idx = self.index
        rg = self.footer["row_groups"][rg_i]
        base = int(np.searchsorted(idx.row_group, rg_i, side="left"))
        n_pages = len(rg["x_pages"])
        want_extra = (list(self.extra_schema) if columns is None
                      else [c for c in columns if c in self.extra_schema])
        extra_pages = {k: rg["extra"][k] for k in want_extra}
        runs = [(0, n_pages)]
        stats = ReadStats()
        with obs.span("rg.read_full", cat="io", rg=rg_i, device=device):
            src = _CoalescedRanges(
                self._source,
                self._rg_ranges(rg, runs, base, True, extra_pages),
                self.coalesce_max_gap)
            lv = self._decode_rg_levels(src, rg, stats)
            rec_vcounts = lv.record_value_counts()
            n_rec = lv.n_rec
            extra_all = {
                k: np.empty(n_rec, np.dtype(self.extra_schema[k]))
                for k in want_extra
            }
            self._decode_run_extras(src, extra_pages, extra_all, 0,
                                    0, n_pages, stats)
            if n_pages:
                j0, j1 = base, base + n_pages - 1
                stats.bytes_read += int(idx.x_nbytes[j0 : j1 + 1].sum()
                                        + idx.y_nbytes[j0 : j1 + 1].sum())
            rec0 = int(idx.rec_start[base]) if n_pages else 0

            def coord_blobs(p):
                j = base + p
                meta_x = PageMeta.from_dict(rg["x_pages"][p])
                meta_y = PageMeta.from_dict(rg["y_pages"][p])
                blob_x = self._checked_blob(
                    src, int(idx.x_offset[j]), int(idx.x_nbytes[j]),
                    meta_x.crc, stats, f"x page {p} of row group {rg_i}")
                blob_y = self._checked_blob(
                    src, int(idx.y_offset[j]), int(idx.y_nbytes[j]),
                    meta_y.crc, stats, f"y page {p} of row group {rg_i}")
                return meta_x, blob_x, meta_y, blob_y

            if device == "host":
                total_vals = int(idx.count[base : base + n_pages].sum())
                x_all = np.empty(total_vals, self.coord_dtype)
                y_all = np.empty(total_vals, self.coord_dtype)
                w = 0
                with obs.span("rg.decode", cat="decode", rg=rg_i,
                              device="host"):
                    for p in range(n_pages):
                        meta_x, blob_x, meta_y, blob_y = coord_blobs(p)
                        cnt = int(idx.count[base + p])
                        decode_page(blob_x, meta_x, self.coord_dtype,
                                    self.codec, out=x_all[w : w + cnt])
                        decode_page(blob_y, meta_y, self.coord_dtype,
                                    self.codec, out=y_all[w : w + cnt])
                        w += cnt
                return RowGroupData(rg_i, n_rec, rec_vcounts, lv, extra_all,
                                    stats.bytes_read, x=x_all, y=y_all)

            from repro_torch.kernels.fp_delta import (
                build_page_stream,
                build_refine_aux,
                chunk_plan_pairs,
            )

            plans: list = []
            pairs: list[tuple[int, int]] = []
            with obs.span("rg.plan", cat="plan", rg=rg_i, pages=n_pages):
                for p in range(n_pages):
                    meta_x, blob_x, meta_y, blob_y = coord_blobs(p)
                    plans.append(page_stream_plan(
                        blob_x, meta_x, self.coord_dtype, self.codec))
                    plans.append(page_stream_plan(
                        blob_y, meta_y, self.coord_dtype, self.codec))
                    j = base + p
                    r0 = int(idx.rec_start[j]) - rec0
                    pairs.append((r0, r0 + int(idx.rec_count[j])))
            chunks: list[RowGroupChunk] = []
            for kind, cplans, cpairs, (rl, rh) in chunk_plan_pairs(plans, pairs):
                if kind == "host":
                    chunks.append(RowGroupChunk(
                        "host", rl, rh,
                        x=fp_delta_execute(cplans[0]),
                        y=fp_delta_execute(cplans[1])))
                    continue
                stream = build_page_stream(cplans)
                aux = build_refine_aux(
                    stream, [(a - rl, b - rl) for a, b in cpairs],
                    rec_vcounts[rl:rh])
                chunks.append(RowGroupChunk("dev", rl, rh,
                                            stream=stream, aux=aux))
            return RowGroupData(rg_i, n_rec, rec_vcounts, lv, extra_all,
                                stats.bytes_read, chunks=chunks)

    def read(self, bbox=None, refine: bool = False,
             device: str = "cuda") -> tuple[list[Geometry], ReadStats]:
        """Object-API read returning Geometry instances."""
        geo, _, stats = self.read_columnar(bbox=bbox, refine=refine,
                                           device=device)
        return (assemble(geo) if geo is not None else []), stats


def _bbox_keep_mask(x: np.ndarray, y: np.ndarray, counts: np.ndarray,
                    bbox) -> np.ndarray:
    """Exact per-record bbox mask over contiguous value slices (the host
    refinement oracle: NaN-propagating ``minimum.reduceat`` + float
    compares — any NaN coordinate drops its record). The query box goes
    through the shared :func:`~repro_torch.core.filters.canonical_bbox` rule
    first, so an empty box (NaN bound / inverted extent) keeps nothing —
    the same answer the shard-, page- and device-record-level tests give.
    """
    counts = np.asarray(counts, np.int64)
    keep = np.zeros(len(counts), dtype=bool)
    bbox = canonical_bbox(bbox)
    if bbox is None:
        return keep
    starts = np.cumsum(counts) - counts
    nz = counts > 0
    if nz.any():
        s = starts[nz]
        xs = x.astype(np.float64, copy=False)
        ys = y.astype(np.float64, copy=False)
        xmin = np.minimum.reduceat(xs, s)
        xmax = np.maximum.reduceat(xs, s)
        ymin = np.minimum.reduceat(ys, s)
        ymax = np.maximum.reduceat(ys, s)
        qx0, qy0, qx1, qy1 = bbox
        keep[nz] = (xmin <= qx1) & (xmax >= qx0) & (ymin <= qy1) & (ymax >= qy0)
    return keep


def _records_intersecting(cols: GeometryColumns, bbox) -> np.ndarray:
    """Vectorized exact per-record bbox test (refinement step)."""
    starts = cols.record_value_starts()
    counts = np.diff(np.append(starts, cols.n_values))
    return np.flatnonzero(_bbox_keep_mask(cols.x, cols.y, counts, bbox))
