"""Fault-tolerant I/O for Spatial Parquet readers: the storage boundary.

The reader's whole storage contract is positional range reads; this package
abstracts it behind :class:`ByteRangeSource` and provides the two backends —
a local file preserving the historical single-``readinto``-per-merged-run
behaviour byte-for-byte, and an object-store-style remote source with
retry/backoff, deadlines, bounded concurrency, request coalescing and a
read-through block cache — plus the checksum layer (format v2) and the
deterministic fault-injection server the whole stack is tested against::

    from repro_torch.io import (
        ByteRangeSource, LocalFileSource, RemoteRangeSource,  # sources
        InProcessRangeServer, FaultSpec,                      # fault harness
        crc32c, ChecksumError,                                # integrity
    )

    server = InProcessRangeServer("lake/shard-00000.spqf",
                                  faults=[FaultSpec("error", times=2)])
    src = RemoteRangeSource(server, timeout=0.2, max_retries=4)
    with SpatialParquetReader(source=src) as r:     # recovers transparently
        geo, extras, stats = r.read_columnar()      # stats.retries == 2
"""

from .checksum import (
    CHECKSUM_CRC32,
    CHECKSUM_CRC32C,
    ChecksumError,
    checksum_fn,
    crc32,
    crc32c,
    default_algo,
    have_native_crc32c,
)
from .durable import (
    TMP_MARKER,
    fsync_dir,
    fsync_file,
    fsync_path,
    is_tmp_name,
    write_atomic,
)
from .faults import (
    CRASH_COMMIT_POST_RENAME,
    CRASH_COMMIT_PRE_RENAME,
    CRASH_COMPACT_MID,
    CRASH_GC_MID,
    CRASH_POINTS,
    CRASH_SHARD_TORN,
    FAULT_CORRUPT,
    FAULT_ERROR,
    FAULT_STALL,
    FAULT_TRUNCATE,
    CrashSpec,
    FaultSpec,
    InjectedCrash,
    InProcessRangeServer,
    RangeResponse,
    arm_crash,
    crash_armed,
    crash_injection,
    disarm_crashes,
    maybe_crash,
)
from .remote import (
    RangeRequestError,
    RemoteRangeSource,
    RequestTimeout,
    RetriesExhausted,
    TransientServerError,
)
from .source import (
    ByteRangeSource,
    BytesSource,
    LocalFileSource,
    SourceStats,
    open_source,
)

__all__ = [
    "ByteRangeSource",
    "BytesSource",
    "LocalFileSource",
    "RemoteRangeSource",
    "SourceStats",
    "open_source",
    "InProcessRangeServer",
    "FaultSpec",
    "RangeResponse",
    "FAULT_TRUNCATE",
    "FAULT_ERROR",
    "FAULT_STALL",
    "FAULT_CORRUPT",
    "InjectedCrash",
    "CrashSpec",
    "arm_crash",
    "disarm_crashes",
    "crash_armed",
    "crash_injection",
    "maybe_crash",
    "CRASH_POINTS",
    "CRASH_SHARD_TORN",
    "CRASH_COMMIT_PRE_RENAME",
    "CRASH_COMMIT_POST_RENAME",
    "CRASH_COMPACT_MID",
    "CRASH_GC_MID",
    "write_atomic",
    "fsync_file",
    "fsync_path",
    "fsync_dir",
    "is_tmp_name",
    "TMP_MARKER",
    "TransientServerError",
    "RangeRequestError",
    "RequestTimeout",
    "RetriesExhausted",
    "ChecksumError",
    "checksum_fn",
    "crc32",
    "crc32c",
    "default_algo",
    "have_native_crc32c",
    "CHECKSUM_CRC32",
    "CHECKSUM_CRC32C",
]
