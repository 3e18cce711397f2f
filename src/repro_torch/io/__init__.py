"""The reader's storage boundary and the format-v2 checksums.

The port carries the local-file source and the checksum layer::

    from repro_torch.io import LocalFileSource, crc32c, ChecksumError
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
    "SourceStats",
    "open_source",
    "ChecksumError",
    "checksum_fn",
    "crc32",
    "crc32c",
    "default_algo",
    "have_native_crc32c",
    "CHECKSUM_CRC32",
    "CHECKSUM_CRC32C",
]
