"""Blob checksums for Spatial Parquet integrity (format v2).

Every stored blob of a v2 file (level streams, coordinate/extra pages, the
footer itself) carries a 32-bit checksum so corruption — a bit-flipped
object-store response, a truncated page, a stale cache block — is detected
*before* FP-delta plans or Pallas launches consume garbage.

Two algorithms are supported and the footer records which one a file uses
(``checksum_algo``):

* ``crc32c`` — CRC-32 Castagnoli, the Parquet/iSCSI polynomial. Used when a
  native implementation (``google_crc32c``) is importable at write time; a
  pure-Python table fallback keeps such files *readable* everywhere (slow,
  correctness-plane only).
* ``crc32`` — zlib's CRC-32 (ISO-HDLC). The stdlib-only default when no
  native CRC32C is available: integrity without a pure-Python hot loop.

Both are functions ``(bytes-like) -> uint32``. Files record the stored CRC of
the blob *as written* (post-compression), so verification happens on the raw
bytes before any decompress/decode work.
"""

from __future__ import annotations

import zlib

CHECKSUM_CRC32C = "crc32c"
CHECKSUM_CRC32 = "crc32"

try:  # native CRC32C (C extension); optional
    import google_crc32c as _gcrc32c
except ImportError:  # pragma: no cover - depends on environment
    _gcrc32c = None


class ChecksumError(IOError):
    """A stored blob failed checksum verification (and re-fetch, if any).

    Carries enough attribution to name the corrupt byte range: ``what`` (a
    human label like ``"x page 3 of row group 1"``), ``offset`` and
    ``nbytes`` of the stored blob, and the stored/computed CRC values.
    """

    def __init__(self, what: str, offset: int, nbytes: int,
                 stored: int, computed: int):
        super().__init__(
            f"checksum mismatch in {what} at offset {offset} ({nbytes} bytes): "
            f"stored {stored:#010x} != computed {computed:#010x}"
        )
        self.what = what
        self.offset = int(offset)
        self.nbytes = int(nbytes)
        self.stored = int(stored)
        self.computed = int(computed)


def _crc32c_table() -> list[int]:
    poly = 0x82F63B78  # reflected Castagnoli polynomial
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_SW_TABLE: list[int] | None = None


def _crc32c_software(data, value: int = 0) -> int:
    """Pure-Python CRC32C. Correct but slow — the read-compat fallback for
    files whose footer says ``crc32c`` when no native wheel is importable."""
    global _SW_TABLE
    if _SW_TABLE is None:
        _SW_TABLE = _crc32c_table()
    table = _SW_TABLE
    crc = (value ^ 0xFFFFFFFF) & 0xFFFFFFFF
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc32c(data, value: int = 0) -> int:
    """CRC-32C (Castagnoli) of a bytes-like; native when available."""
    if _gcrc32c is not None:
        return _gcrc32c.extend(value, bytes(data))
    return _crc32c_software(data, value)


def crc32(data, value: int = 0) -> int:
    """zlib CRC-32 of a bytes-like (always fast: stdlib C)."""
    return zlib.crc32(bytes(data), value) & 0xFFFFFFFF


def have_native_crc32c() -> bool:
    return _gcrc32c is not None


def default_algo() -> str:
    """Algorithm new files should use: crc32c when it is fast here."""
    return CHECKSUM_CRC32C if have_native_crc32c() else CHECKSUM_CRC32


def checksum_fn(algo: str):
    """The ``(bytes-like) -> uint32`` function for a footer's algo tag."""
    if algo == CHECKSUM_CRC32C:
        return crc32c
    if algo == CHECKSUM_CRC32:
        return crc32
    raise ValueError(f"unknown checksum algorithm {algo!r}")
