"""Dataset manifest: the JSON catalog of a sharded Spatial Parquet lake.

A *dataset* is a directory of ``.spqf`` shard files plus a ``manifest.json``
describing them — the multi-file analog of one file's footer. Per shard it
records the MBR (the shard-level spatial index pruned before any shard file
is even opened), row/value counts, and the page/byte totals needed to keep
:class:`~repro_torch.core.reader.ReadStats` honest for shards that were pruned
without being read. Dataset-wide schema (coordinate dtype, codec, encoding,
extra columns, SFC sort method) lives at the top level so every shard is
interchangeable.

The manifest is deliberately plain JSON (not msgpack like the footer): it is
the human-visible catalog of the lake, the piece an external orchestrator
(or a later object-store layout) would list and diff.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

from .errors import DatasetError

MANIFEST_NAME = "manifest.json"
DATASET_FORMAT = "spatial-parquet-dataset"
MANIFEST_VERSION = 1


@dataclass
class ShardInfo:
    """One shard's catalog entry (everything pruning needs, file unopened)."""

    path: str  # relative to the dataset root
    mbr: tuple[float, float, float, float]  # xmin, ymin, xmax, ymax
    n_records: int
    n_values: int
    n_pages: int  # x/y page pairs (per-page index size)
    data_bytes: int  # stored bytes of every blob in the shard
    file_bytes: int  # on-disk size incl. magic + footer
    crc32c: int | None = None  # whole-file CRC-32C (catalog commits set it)
    # per-column zone map: {col: {"min", "max", "nnan", "count"}} over the
    # whole shard (min/max are None when the column has no non-NaN values);
    # lets DatasetIndex.query(bbox, filter=) prune the shard from the
    # manifest alone, before its file is opened. Optional: older snapshots
    # and pre-zone-map shards simply never get predicate-pruned.
    zone_maps: dict | None = None

    def to_dict(self) -> dict:
        d = {
            "path": self.path,
            "mbr": [float(v) for v in self.mbr],
            "n_records": int(self.n_records),
            "n_values": int(self.n_values),
            "n_pages": int(self.n_pages),
            "data_bytes": int(self.data_bytes),
            "file_bytes": int(self.file_bytes),
        }
        if self.crc32c is not None:
            d["crc32c"] = int(self.crc32c)
        if self.zone_maps is not None:
            d["zone_maps"] = {
                k: {
                    "min": None if z["min"] is None else float(z["min"]),
                    "max": None if z["max"] is None else float(z["max"]),
                    "nnan": int(z["nnan"]),
                    "count": int(z["count"]),
                }
                for k, z in self.zone_maps.items()
            }
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ShardInfo":
        return cls(
            path=d["path"],
            mbr=tuple(d["mbr"]),
            n_records=d["n_records"],
            n_values=d["n_values"],
            n_pages=d["n_pages"],
            data_bytes=d["data_bytes"],
            file_bytes=d["file_bytes"],
            crc32c=d.get("crc32c"),
            zone_maps=d.get("zone_maps"),
        )

    def validate(self, index: int, where: str) -> None:
        """Structural checks beyond mere key presence (see ``load``)."""
        who = f"{where}: shards[{index}]"
        if not isinstance(self.path, str) or not self.path:
            raise DatasetError(f"{who}: 'path' must be a non-empty string")
        p = self.path.replace("\\", "/")
        if p.startswith("/") or p.startswith("~") or ".." in p.split("/"):
            # shard paths are catalog-relative by contract; an absolute or
            # parent-escaping path would let a manifest read arbitrary files
            raise DatasetError(
                f"{who}: path {self.path!r} escapes the dataset root")
        if len(self.mbr) != 4 or not all(
                isinstance(v, (int, float)) for v in self.mbr):
            raise DatasetError(f"{who}: 'mbr' must be 4 numbers, got "
                               f"{self.mbr!r}")
        for k in ("n_records", "n_values", "n_pages", "data_bytes",
                  "file_bytes"):
            v = getattr(self, k)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                raise DatasetError(
                    f"{who}: {k!r} must be a non-negative integer, got {v!r}")
        if self.crc32c is not None and (
                not isinstance(self.crc32c, int) or isinstance(self.crc32c, bool)
                or not (0 <= self.crc32c < 1 << 32)):
            raise DatasetError(
                f"{who}: 'crc32c' must be a uint32, got {self.crc32c!r}")
        if self.zone_maps is not None:
            if not isinstance(self.zone_maps, dict):
                raise DatasetError(
                    f"{who}: 'zone_maps' must be an object, got "
                    f"{type(self.zone_maps).__name__}")
            for col, z in self.zone_maps.items():
                zwho = f"{who}: zone_maps[{col!r}]"
                if not isinstance(z, dict) or not {
                        "min", "max", "nnan", "count"} <= set(z):
                    raise DatasetError(
                        f"{zwho}: needs min/max/nnan/count, got {z!r}")
                for k in ("min", "max"):
                    if z[k] is not None and not isinstance(
                            z[k], (int, float)):
                        raise DatasetError(
                            f"{zwho}: {k!r} must be a number or null, got "
                            f"{z[k]!r}")
                for k in ("nnan", "count"):
                    if (not isinstance(z[k], int) or isinstance(z[k], bool)
                            or z[k] < 0):
                        raise DatasetError(
                            f"{zwho}: {k!r} must be a non-negative integer, "
                            f"got {z[k]!r}")
                if (z["min"] is None) != (z["max"] is None):
                    raise DatasetError(
                        f"{zwho}: min/max must be both set or both null")


@dataclass
class DatasetManifest:
    coord_dtype: str
    codec: str
    encoding: str
    sort: str | None
    extra_schema: dict[str, str]
    shards: list[ShardInfo] = field(default_factory=list)
    version: int = MANIFEST_VERSION

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def n_records(self) -> int:
        return sum(s.n_records for s in self.shards)

    @property
    def n_values(self) -> int:
        return sum(s.n_values for s in self.shards)

    @property
    def mbr(self) -> tuple[float, float, float, float] | None:
        """Union MBR of all shards (None for an empty dataset)."""
        boxes = [s.mbr for s in self.shards if s.mbr[0] <= s.mbr[2]]
        if not boxes:
            return None
        return (
            min(b[0] for b in boxes),
            min(b[1] for b in boxes),
            max(b[2] for b in boxes),
            max(b[3] for b in boxes),
        )

    def to_dict(self) -> dict:
        return {
            "format": DATASET_FORMAT,
            "version": self.version,
            "coord_dtype": self.coord_dtype,
            "codec": self.codec,
            "encoding": self.encoding,
            "sort": self.sort,
            "extra_schema": dict(self.extra_schema),
            "n_shards": self.n_shards,
            "n_records": self.n_records,
            "shards": [s.to_dict() for s in self.shards],
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1) + "\n"

    def save(self, root, *, fsync: bool = True) -> str:
        """Write ``manifest.json`` atomically (temp + fsync + rename).

        A crashed save can therefore never leave a torn manifest — only the
        complete old or complete new one (plus an orphan temp file the
        catalog GC removes).
        """
        from repro_torch.io.durable import write_atomic

        path = os.path.join(str(root), MANIFEST_NAME)
        write_atomic(path, self.to_json().encode(), fsync=fsync)
        return path

    @classmethod
    def from_dict(cls, d, where: str = "<manifest>") -> "DatasetManifest":
        """Validate a parsed manifest object (shared by ``manifest.json``
        and the catalog's snapshot files, which embed the same structure).

        Any way the catalog can be wrong — wrong ``format`` tag, too-new
        version, missing keys, malformed shard entries, totals that do not
        add up — raises an attributed
        :class:`~repro_torch.dataset.errors.DatasetError` naming ``where`` and the
        offending field, never a raw ``KeyError`` / ``TypeError``.
        """
        path = where
        if not isinstance(d, dict):
            raise DatasetError(
                f"{path}: manifest must be a JSON object, got "
                f"{type(d).__name__}")
        if d.get("format") != DATASET_FORMAT:
            raise DatasetError(
                f"{path}: not a {DATASET_FORMAT} manifest "
                f"(format={d.get('format')!r})")
        version = d.get("version", 0)
        if not isinstance(version, int) or version < 1:
            raise DatasetError(f"{path}: bad manifest version {version!r}")
        if version > MANIFEST_VERSION:
            raise DatasetError(
                f"{path}: manifest version {version} is newer than this "
                f"library understands (<= {MANIFEST_VERSION})")
        for key in ("coord_dtype", "codec", "encoding", "shards"):
            if key not in d:
                raise DatasetError(f"{path}: manifest missing key {key!r}")
        if not isinstance(d["shards"], list):
            raise DatasetError(f"{path}: 'shards' must be a list, got "
                               f"{type(d['shards']).__name__}")
        shards = []
        for i, s in enumerate(d["shards"]):
            if not isinstance(s, dict):
                raise DatasetError(
                    f"{path}: shards[{i}] must be an object, got "
                    f"{type(s).__name__}")
            try:
                info = ShardInfo.from_dict(s)
            except KeyError as exc:
                raise DatasetError(
                    f"{path}: shards[{i}] missing key {exc.args[0]!r}"
                ) from None
            except (TypeError, ValueError) as exc:
                raise DatasetError(
                    f"{path}: shards[{i}] malformed: {exc}") from exc
            info.validate(i, path)
            shards.append(info)
        extra_schema = d.get("extra_schema", {})
        if not isinstance(extra_schema, dict):
            raise DatasetError(f"{path}: 'extra_schema' must be an object")
        manifest = cls(
            coord_dtype=d["coord_dtype"],
            codec=d["codec"],
            encoding=d["encoding"],
            sort=d.get("sort"),
            extra_schema=dict(extra_schema),
            shards=shards,
            version=version,
        )
        for key, actual in (("n_shards", manifest.n_shards),
                            ("n_records", manifest.n_records)):
            declared = d.get(key)
            if declared is not None and declared != actual:
                raise DatasetError(
                    f"{path}: declared {key}={declared} but shard entries "
                    f"give {actual} (partial write?)")
        return manifest

    @classmethod
    def load(cls, root) -> "DatasetManifest":
        """Load and validate from a dataset directory (or a manifest.json
        path directly); see :meth:`from_dict` for the validation contract.

        Note: for catalog-managed datasets ``manifest.json`` is an
        atomically-maintained *mirror* of the newest committed snapshot —
        generation-aware readers should go through
        :class:`~repro_torch.dataset.catalog.Catalog` instead.
        """
        path = str(root)
        if os.path.isdir(path):
            path = os.path.join(path, MANIFEST_NAME)
        try:
            with open(path) as fh:
                d = json.load(fh)
        except FileNotFoundError:
            raise DatasetError(
                f"{path}: no manifest found (not a dataset directory?)"
            ) from None
        except json.JSONDecodeError as exc:
            raise DatasetError(
                f"{path}: manifest is not valid JSON "
                f"(truncated or partially written?): {exc}") from exc
        except OSError as exc:
            raise DatasetError(f"{path}: cannot read manifest: {exc}") from exc
        return cls.from_dict(d, where=path)


def is_dataset(path) -> bool:
    """True if ``path`` is a dataset directory (holds a manifest.json)."""
    p = str(path)
    return os.path.isdir(p) and os.path.isfile(os.path.join(p, MANIFEST_NAME))


def shard_path(root, shard: ShardInfo) -> str:
    """Absolute path of a shard file under the dataset root."""
    return os.path.join(str(root), shard.path)
