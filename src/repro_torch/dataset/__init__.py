"""Sharded Spatial Parquet datasets: a geospatial data lake of .spqf shards.

The paper's light-weight index skips pages inside one file; this package
lifts the same idea to a *lake* of many files::

    from repro_torch.dataset import (
        write_dataset, SpatialDatasetWriter,      # partition by SFC key
        DatasetManifest, ShardInfo, is_dataset,   # the JSON catalog
        DatasetIndex,                             # shard-level MBR pruning
        SpatialDatasetScanner,                    # async fan-out queries
        Catalog, Compactor,                       # snapshots, compaction, GC
    )

    manifest = write_dataset("lake/porto", columns=cols, n_shards=8)
    sc = SpatialDatasetScanner("lake/porto")
    geo, extras, stats = sc.scan(bbox=(-8.65, 41.14, -8.58, 41.19))
    # stats.shards_read / stats.shards_total, stats.bytes_read / bytes_total

Mutations are crash-safe: every write is an atomic snapshot commit
(:class:`Catalog`), scans pin the generation they read
(:class:`SpatialDatasetScanner`), and :class:`Compactor` merges small
adjacent shards in the background without disturbing pinned readers.
"""

from .catalog import (
    Catalog,
    CommitTx,
    Compactor,
    PinnedSnapshot,
    Snapshot,
    file_crc32c,
    pinned_generations,
)
from .errors import CommitConflict, DatasetError, ShardFailure, ShardReadError
from .index import DatasetIndex
from .manifest import (
    DATASET_FORMAT,
    MANIFEST_NAME,
    DatasetManifest,
    ShardInfo,
    is_dataset,
    shard_path,
)
from .scanner import ON_ERROR_POLICIES, SpatialDatasetScanner
from .writer import SpatialDatasetWriter, write_dataset

__all__ = [
    "DATASET_FORMAT",
    "MANIFEST_NAME",
    "DatasetManifest",
    "ShardInfo",
    "is_dataset",
    "shard_path",
    "DatasetIndex",
    "DatasetError",
    "CommitConflict",
    "ShardFailure",
    "ShardReadError",
    "ON_ERROR_POLICIES",
    "SpatialDatasetScanner",
    "SpatialDatasetWriter",
    "write_dataset",
    "Catalog",
    "CommitTx",
    "Compactor",
    "Snapshot",
    "PinnedSnapshot",
    "file_crc32c",
    "pinned_generations",
]
