"""Sharded dataset writer: partition geometries by SFC key into N shards.

Records are sorted once by their space-filling-curve key (paper §4, over the
*global* extent) and split into ``n_shards`` contiguous key ranges, so each
shard covers a compact region of the curve and shard MBRs stay tight — the
same clustering argument that makes per-page [min,max] statistics selective
(paper Figure 7), lifted one level up. Shards are written pre-sorted
(``sort=None`` at the file level), which makes the concatenation of shards in
manifest order *identical* to one file written with the same global sort:
dataset reads are bit-compatible with single-file reads.

``device`` is where each shard's float32 zone stats reduce: ``"cuda"``
(the default) launches the ``page_minmax`` kernel, ``"cpu"`` runs its
plain version; the bytes written are the same.

Two APIs, mirroring :mod:`repro_torch.core.writer`:

* :func:`write_dataset` — one-shot convenience, returns the manifest.
* :class:`SpatialDatasetWriter` — buffering writer with ``write_columns`` /
  ``write_geometries`` and a closing partition+flush, for streaming callers.

Writes are **transactional**: shard files are staged through a
:class:`~repro_torch.dataset.catalog.CommitTx` and published by an atomic snapshot
commit (temp file + fsync + rename — see :mod:`repro_torch.dataset.catalog`).
An exception mid-write aborts the transaction and deletes the partial shard
files it staged; a simulated crash
(:class:`~repro_torch.io.faults.InjectedCrash`) leaves them as orphans for the
catalog GC, exactly like a real kill. Either way the directory always
reopens as a complete generation — the previous one until the commit
rename, the new one after it. Writing into a directory that already holds a
dataset layers a *new generation* on top (generation-qualified shard names,
never overwriting live files) instead of clobbering it.
"""

from __future__ import annotations

import os

import numpy as np

from repro_torch._device import torch_device
from repro_torch.core.columnar import GeometryColumns, shred
from repro_torch.core.sfc import sort_keys
from repro_torch.core.writer import (
    concat_columns,
    permute_records,
    record_centroids,
)

from .catalog import Catalog
from .manifest import DatasetManifest, ShardInfo

SHARD_NAME = "shard-{:05d}.spqf"


def _shard_mbr(cols: GeometryColumns) -> tuple[float, float, float, float]:
    """MBR over every coordinate value; an all-empty shard gets an
    inverted box that no query intersects (it is still read by full scans,
    which never consult MBRs)."""
    if cols.n_values == 0:
        return (float("inf"), float("inf"), float("-inf"), float("-inf"))
    return (
        float(cols.x.min()), float(cols.y.min()),
        float(cols.x.max()), float(cols.y.max()),
    )


class SpatialDatasetWriter:
    """Buffering sharded writer; ``close()`` partitions and writes the lake.

    ``sort`` picks the SFC used for partitioning *and* the record order
    inside each shard ('z' | 'hilbert' | None = arrival order). Remaining
    keyword arguments (``encoding``, ``codec``, ``page_values``,
    ``row_group_records``, ``extra_schema``, ``device``) pass through to each shard's
    :class:`~repro_torch.core.writer.SpatialParquetWriter`.
    """

    def __init__(
        self,
        root,
        *,
        n_shards: int = 4,
        sort: str | None = "hilbert",
        sfc_order: int = 16,
        encoding: str = "fp_delta",
        codec: str = "none",
        page_values: int = 131072,
        row_group_records: int = 1 << 20,
        extra_schema: dict[str, str] | None = None,
        fsync: bool = True,
        device="cuda",
    ):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        torch_device(device)  # "cuda" without a card raises here
        self.device = device
        self.root = str(root)
        self.n_shards = int(n_shards)
        self.sort = sort
        self.sfc_order = int(sfc_order)
        self.fsync = bool(fsync)
        self.extra_schema = dict(extra_schema or {})
        self._file_kwargs = dict(
            encoding=encoding,
            codec=codec,
            page_values=page_values,
            row_group_records=row_group_records,
            extra_schema=self.extra_schema,
        )
        self._cols_list: list[GeometryColumns] = []
        self._extras: dict[str, list[np.ndarray]] = {k: [] for k in self.extra_schema}
        self._manifest: DatasetManifest | None = None
        self.generation: int | None = None  # set by close()

    # ------------------------------------------------------------------- API
    def write_geometries(self, geometries, extra: dict | None = None) -> None:
        self.write_columns(shred(geometries), extra)

    def write_columns(self, cols: GeometryColumns, extra: dict | None = None) -> None:
        extra = extra or {}
        if set(extra) != set(self.extra_schema):
            raise ValueError(
                f"extra columns {set(extra)} != schema {set(self.extra_schema)}"
            )
        for k, v in extra.items():
            v = np.ascontiguousarray(v, dtype=np.dtype(self.extra_schema[k]))
            if len(v) != cols.n_records:
                raise ValueError(f"extra column {k!r} length mismatch")
            self._extras[k].append(v)
        self._cols_list.append(cols)

    def close(self) -> DatasetManifest:
        if self._manifest is not None:
            return self._manifest
        os.makedirs(self.root, exist_ok=True)
        cols = (
            concat_columns(self._cols_list)
            if self._cols_list
            else GeometryColumns(
                *(np.zeros(0, np.uint8) for _ in range(4)),
                np.zeros(0, np.float64), np.zeros(0, np.float64),
            )
        )
        extras = {
            k: (np.concatenate(v) if v else np.zeros(0, np.dtype(self.extra_schema[k])))
            for k, v in self._extras.items()
        }
        n = cols.n_records
        if self.sort is not None and n > 1:
            cx, cy = record_centroids(cols)
            keys = sort_keys(cx, cy, self.sort, self.sfc_order)
            perm = np.argsort(keys, kind="stable")
        else:
            perm = np.arange(n, dtype=np.int64)

        catalog = Catalog.open(self.root, create=True)
        tx = catalog.begin()
        try:
            shards: list[ShardInfo] = []
            for chunk in np.array_split(perm, self.n_shards):
                if len(chunk) == 0:
                    continue  # fewer records than shards: skip the empty tail
                sub = permute_records(cols, chunk)
                sub_extra = {k: v[chunk] for k, v in extras.items()}
                shards.append(tx.stage_shard(
                    sub, sub_extra, fsync=self.fsync, device=self.device,
                    **self._file_kwargs))
            coord_dtype = (
                np.dtype(cols.x.dtype).str if n else np.dtype(np.float64).str
            )
            manifest = DatasetManifest(
                coord_dtype=coord_dtype,
                codec=self._file_kwargs["codec"],
                encoding=self._file_kwargs["encoding"],
                sort=self.sort,
                extra_schema=self.extra_schema,
                shards=shards,
            )
            snapshot = tx.commit(manifest, fsync=self.fsync)
        except Exception:
            # ordinary failures clean up their partial shard files; a
            # simulated crash (InjectedCrash is a BaseException) skips this
            # by design and leaves the orphans to catalog GC
            tx.abort()
            raise
        self._manifest = manifest
        self.generation = snapshot.generation
        return self._manifest

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_dataset(
    root,
    geometries=None,
    columns: GeometryColumns | None = None,
    extra: dict | None = None,
    **kwargs,
) -> DatasetManifest:
    """One-shot sharded write; returns the saved manifest.

    ``extra_schema`` is inferred from ``extra`` arrays when not given.
    """
    if extra and "extra_schema" not in kwargs:
        kwargs["extra_schema"] = {
            k: np.asarray(v).dtype.str for k, v in extra.items()
        }
    with SpatialDatasetWriter(root, **kwargs) as w:
        if geometries is not None:
            w.write_geometries(geometries, extra)
        if columns is not None:
            w.write_columns(columns, extra)
    return w.close()
