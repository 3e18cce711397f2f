"""Spatial Parquet file writer.

File layout (Parquet-architecture-faithful; byte format is ours since no JVM
Parquet stack exists in-container — see DESIGN.md §10)::

    [magic "SPQF1\\0"]
    [row group 0: type | type_rep | rep | defn | x pages | y pages | extras]
    [row group 1: ...]
    [footer (msgpack)] [footer_nbytes: uint32 LE] [magic "SPQF1\\0"]

Row groups hold up to ``row_group_records`` records (paper: ~1M sort groups;
"we process the records into groups with a fixed number of records...
whenever we have that number of records, we sort them and write them").
Coordinate columns are split into record-aligned ~``page_values``-value pages,
each carrying [min,max] statistics — the light-weight spatial index (§4).

Format v2 (checksums, the default) differs only in integrity metadata: the
magic becomes ``SPQF2\\0``, every stored blob's footer entry gains a ``crc``
of its stored (post-compression) bytes, the footer records which
``checksum_algo`` produced them, and the footer blob itself is followed by a
4-byte CRC32C (``footer_nbytes`` counts blob + CRC)::

    [footer (msgpack)] [footer_crc32c: uint32 LE]
    [footer_nbytes: uint32 LE] [magic "SPQF2\\0"]

``checksums=False`` writes the v1 layout byte-for-byte (no ``crc`` keys, v1
magic); v1 files stay readable forever, just unverified.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import msgpack
import numpy as np

from repro_torch._device import torch_device
from repro_torch.io.checksum import checksum_fn, crc32c, default_algo

from .columnar import GeometryColumns, TorchCoords, from_ragged, shred
from .pages import PageMeta, compress, encode_pages, plan_page_splits
from .rle import encode_levels, rle_encode
from .sfc import sort_keys

MAGIC = b"SPQF1\x00"
MAGIC_V2 = b"SPQF2\x00"
FORMAT_VERSION = 1       # pre-checksum layout (still written by checksums=False)
FORMAT_VERSION_V2 = 2    # per-blob + footer checksums
assert len(MAGIC) == len(MAGIC_V2)


# --------------------------------------------------------------------- ragged
def ragged_gather_indices(lengths: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Element indices that gather ragged segments in ``perm`` order."""
    lengths = np.asarray(lengths, dtype=np.int64)
    starts = np.cumsum(lengths) - lengths
    sel_len = lengths[perm]
    total = int(sel_len.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    out_starts = np.cumsum(sel_len) - sel_len
    idx = np.arange(total, dtype=np.int64)
    seg = np.repeat(np.arange(len(perm)), sel_len)
    return idx - out_starts[seg] + starts[perm[seg]]


def permute_records(cols: GeometryColumns, perm: np.ndarray) -> GeometryColumns:
    """Reorder (or subset) records of a GeometryColumns by record indices."""
    types, coords, part_sizes, parts_per_sub, subs_per_rec = cols.to_ragged()
    perm = np.asarray(perm, dtype=np.int64)
    # level 1: records -> sub-geometry indices
    sub_idx = ragged_gather_indices(subs_per_rec, perm)
    new_types = types[sub_idx]
    new_pps = parts_per_sub[sub_idx]
    new_spr = subs_per_rec[perm]
    # level 2: sub-geometries -> part indices
    part_idx = ragged_gather_indices(parts_per_sub, sub_idx)
    new_part_sizes = part_sizes[part_idx]
    # level 3: parts -> coordinate indices
    coord_idx = ragged_gather_indices(part_sizes, part_idx)
    new_coords = coords[coord_idx]
    return from_ragged(new_types, new_coords, new_part_sizes, new_pps, new_spr)


def concat_columns(cols_list: list[GeometryColumns]) -> GeometryColumns:
    """Concatenate geometry chunks; device-resident coordinate columns
    (:class:`TorchCoords`) merge on their device, never the host."""
    if len(cols_list) == 1:
        return cols_list[0]

    def cat_coords(parts):
        dev = [p.bits.device for p in parts if isinstance(p, TorchCoords)]
        if dev:
            return TorchCoords.concat([
                p if isinstance(p, TorchCoords) else TorchCoords.from_numpy(p, dev[0])
                for p in parts
            ])
        return np.concatenate(parts)

    return GeometryColumns(
        np.concatenate([c.types for c in cols_list]),
        np.concatenate([c.type_rep for c in cols_list]),
        np.concatenate([c.rep for c in cols_list]),
        np.concatenate([c.defn for c in cols_list]),
        cat_coords([c.x for c in cols_list]),
        cat_coords([c.y for c in cols_list]),
    )


def record_centroids(cols: GeometryColumns) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized per-record bbox centers (empty records get (0,0))."""
    n_rec = cols.n_records
    starts = cols.record_value_starts()
    counts = np.diff(np.append(starts, cols.n_values))
    cx = np.zeros(n_rec, dtype=np.float64)
    cy = np.zeros(n_rec, dtype=np.float64)
    nz = counts > 0
    if nz.any():
        s = starts[nz]
        x = cols.x.astype(np.float64, copy=False)
        y = cols.y.astype(np.float64, copy=False)
        cx[nz] = (np.minimum.reduceat(x, s) + np.maximum.reduceat(x, s)) / 2.0
        cy[nz] = (np.minimum.reduceat(y, s) + np.maximum.reduceat(y, s)) / 2.0
        # reduceat's final segment runs to the end of the array, which is what
        # we want for the last nonempty record; interior empty records were
        # masked out so every reduceat segment spans exactly one record...
        # ...except when an empty record sits between two nonempty ones: the
        # segment of the record before it still ends at the next *nonempty*
        # start because empty records own zero values. Correct by construction.
    return cx, cy


@dataclass
class _PendingGroup:
    cols_list: list
    extras: dict[str, list]
    n_records: int = 0


class SpatialParquetWriter:
    """Streaming writer with bounded-memory SFC sorting (paper §4).

    ``device`` is where the float32 extra columns' page statistics reduce:
    ``"cuda"`` (the default) launches the ``page_minmax`` kernel, ``"cpu"``
    runs its plain version. The bytes written are the same either way.
    """

    def __init__(
        self,
        path,
        *,
        encoding: str = "fp_delta",
        codec: str = "none",
        page_values: int = 131072,
        row_group_records: int = 1 << 20,
        sort: str | None = None,  # None | 'z' | 'hilbert'
        sfc_order: int = 16,
        extra_schema: dict[str, str] | None = None,  # name -> numpy dtype str
        checksums: bool = True,
        checksum_algo: str | None = None,  # None -> fastest available
        device="cuda",
    ):
        self.device = torch_device(device)
        self.path = str(path)
        self.encoding = encoding
        self.codec = codec
        self.page_values = int(page_values)
        self.row_group_records = int(row_group_records)
        self.sort = sort
        self.sfc_order = int(sfc_order)
        self.extra_schema = dict(extra_schema or {})
        self.checksums = bool(checksums)
        self.checksum_algo = (
            (checksum_algo or default_algo()) if self.checksums else None
        )
        # resolve the algo now so an unknown name fails before any bytes land
        self._crc = checksum_fn(self.checksum_algo) if self.checksums else None
        self._fh = open(self.path, "wb")
        self._fh.write(MAGIC_V2 if self.checksums else MAGIC)
        self._offset = len(MAGIC)
        self._pending = _PendingGroup([], {k: [] for k in self.extra_schema})
        self._row_groups: list[dict] = []
        self._coord_dtype: str | None = None
        self._closed = False

    # ------------------------------------------------------------------- API
    def write_geometries(self, geometries, extra: dict | None = None) -> None:
        self.write_columns(shred(geometries), extra)

    def write_columns(self, cols: GeometryColumns, extra: dict | None = None) -> None:
        dt = np.dtype(cols.x.dtype).str
        if self._coord_dtype is None:
            self._coord_dtype = dt
        elif self._coord_dtype != dt:
            raise ValueError("mixed coordinate dtypes in one file")
        extra = extra or {}
        if set(extra) != set(self.extra_schema):
            raise ValueError(f"extra columns {set(extra)} != schema {set(self.extra_schema)}")
        for k, v in extra.items():
            v = np.ascontiguousarray(v, dtype=np.dtype(self.extra_schema[k]))
            if len(v) != cols.n_records:
                raise ValueError(f"extra column {k!r} length mismatch")
            self._pending.extras[k].append(v)
        self._pending.cols_list.append(cols)
        self._pending.n_records += cols.n_records
        while self._pending.n_records >= self.row_group_records:
            self._flush_group(self.row_group_records)

    def close(self) -> dict:
        if self._closed:
            return self._footer
        if self._pending.n_records:
            self._flush_group(self._pending.n_records)
        footer = {
            "version": FORMAT_VERSION_V2 if self.checksums else FORMAT_VERSION,
            "coord_dtype": self._coord_dtype or "<f8",
            "encoding": self.encoding,
            "codec": self.codec,
            "sort": self.sort,
            "n_records": int(sum(g["n_records"] for g in self._row_groups)),
            "extra_schema": self.extra_schema,
            "row_groups": self._row_groups,
        }
        if self.checksums:
            footer["checksum_algo"] = self.checksum_algo
        blob = msgpack.packb(footer, use_bin_type=True)
        if self.checksums:
            # the footer checksum is always CRC32C (the algo tag lives inside
            # the footer, so it cannot govern its own verification)
            blob += struct.pack("<I", crc32c(blob))
        self._fh.write(blob)
        self._fh.write(struct.pack("<I", len(blob)))
        self._fh.write(MAGIC_V2 if self.checksums else MAGIC)
        self._fh.close()
        self._footer = footer
        self._closed = True
        return footer

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -------------------------------------------------------------- internals
    def _take_records(self, n: int) -> tuple[GeometryColumns, dict[str, np.ndarray]]:
        """Pop exactly n records (and matching extras) from the pending buffer."""
        cols = concat_columns(self._pending.cols_list)
        extras = {
            k: (np.concatenate(v) if v else np.zeros(0, dtype=self.extra_schema[k]))
            for k, v in self._pending.extras.items()
        }
        total = cols.n_records
        if n < total:
            head = cols.slice_records(0, n)
            tail = cols.slice_records(n, total)
            self._pending = _PendingGroup(
                [tail], {k: [v[n:]] for k, v in extras.items()}, total - n
            )
            extras = {k: v[:n] for k, v in extras.items()}
            cols = head
        else:
            self._pending = _PendingGroup([], {k: [] for k in self.extra_schema})
        return cols, extras

    def _flush_group(self, n: int) -> None:
        cols, extras = self._take_records(n)
        if self.sort is not None and cols.n_records > 1:
            cx, cy = record_centroids(cols)
            keys = sort_keys(cx, cy, self.sort, self.sfc_order)
            perm = np.argsort(keys, kind="stable")
            cols = permute_records(cols, perm)
            extras = {k: v[perm] for k, v in extras.items()}
        self._write_row_group(cols, extras)

    def _write_blob(self, buf: bytes) -> tuple[int, int, int | None]:
        off = self._offset
        self._fh.write(buf)
        self._offset += len(buf)
        crc = self._crc(buf) if self._crc is not None else None
        return off, len(buf), crc

    def _write_row_group(self, cols: GeometryColumns, extras: dict) -> None:
        rg: dict = {"n_records": cols.n_records, "n_values": cols.n_values}
        # small columns: type (RLE, paper §3.1) + level streams
        for name, buf in (
            ("type", rle_encode(cols.types)),
            ("type_rep", encode_levels(cols.type_rep)),
            ("rep", encode_levels(cols.rep)),
            ("defn", encode_levels(cols.defn)),
        ):
            comp = compress(buf, self.codec)
            off, nb, crc = self._write_blob(comp)
            rg[name] = {"offset": off, "nbytes": nb, "raw_nbytes": len(buf)}
            if crc is not None:
                rg[name]["crc"] = crc
        # coordinate pages (x and y share record-aligned boundaries => bbox/page)
        # batch-encoded: one delta/zigzag/bit-count pass per axis feeds every
        # page's n* optimizer and token emitter (see fp_delta_encode_pages)
        starts = cols.record_value_starts()
        splits = plan_page_splits(starts, cols.n_values, self.page_values)
        bounds = np.append(starts, cols.n_values)
        vbounds = [(int(bounds[r0]), int(bounds[r1])) for r0, r1 in splits]
        for axis, values in (("x", cols.x), ("y", cols.y)):
            pages = []
            encoded = encode_pages(values, vbounds, self.encoding, self.codec)
            for (buf, st), (r0, r1), (v0, v1) in zip(encoded, splits, vbounds):
                chunk = values[v0:v1]
                off, nb, crc = self._write_blob(buf)
                pages.append(
                    PageMeta(
                        offset=off, nbytes=nb, count=v1 - v0,
                        rec_start=r0, rec_count=r1 - r0,
                        vmin=float(chunk.min()) if len(chunk) else float("inf"),
                        vmax=float(chunk.max()) if len(chunk) else float("-inf"),
                        encoding=self.encoding,
                        n_bits=st["n_bits"], n_resets=st["n_resets"],
                        crc=crc,
                    ).to_dict()
                )
            rg[f"{axis}_pages"] = pages
        # extra per-record columns, page-aligned with the coordinate pages.
        # Numeric columns get NaN-safe per-page zone stats (vmin/vmax over
        # non-NaN values + NaN count) in one batched pass per column — the
        # float32 path reduces on-device through page_minmax — plus a
        # per-row-group aggregate under rg["extra_stats"] that the catalog
        # rolls into the shard's persisted zone map.
        rg["extra"] = {}
        rg["extra_stats"] = {}
        ebounds = np.array([r0 for r0, _ in splits] + [cols.n_records], np.int64)
        for k, v in extras.items():
            pages = []
            enc = self.encoding if v.dtype.itemsize in (4, 8) else "raw"
            numeric = v.dtype.kind in "iuf"
            if numeric and len(splits):
                from repro_torch.kernels.minmax import column_page_stats_ex

                pmin, pmax, pnan = column_page_stats_ex(v, ebounds,
                                                        device=self.device)
            else:
                pmin = np.full(len(splits), np.inf)
                pmax = np.full(len(splits), -np.inf)
                pnan = np.zeros(len(splits), np.int64)
            encoded = encode_pages(v, [(r0, r1) for r0, r1 in splits], enc, self.codec)
            for p_i, ((buf, st), (r0, r1)) in enumerate(zip(encoded, splits)):
                off, nb, crc = self._write_blob(buf)
                pages.append(
                    PageMeta(
                        offset=off, nbytes=nb, count=r1 - r0,
                        rec_start=r0, rec_count=r1 - r0,
                        vmin=float(pmin[p_i]), vmax=float(pmax[p_i]),
                        encoding=enc, n_bits=st["n_bits"], n_resets=st["n_resets"],
                        crc=crc, nnan=int(pnan[p_i]) if numeric else None,
                    ).to_dict()
                )
            rg["extra"][k] = pages
            if numeric:
                counts = np.diff(ebounds)
                live = counts > pnan  # pages with at least one non-NaN value
                rg["extra_stats"][k] = {
                    "min": float(pmin[live].min()) if live.any() else None,
                    "max": float(pmax[live].max()) if live.any() else None,
                    "nnan": int(pnan.sum()),
                    "count": int(cols.n_records),
                }
        self._row_groups.append(rg)


def write_file(path, geometries=None, columns=None, extra=None, **kwargs) -> dict:
    """One-shot convenience writer; returns the footer."""
    with SpatialParquetWriter(path, **kwargs) as w:
        if geometries is not None:
            w.write_geometries(geometries, extra)
        if columns is not None:
            w.write_columns(columns, extra)
    return w.close()
