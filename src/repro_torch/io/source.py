"""ByteRangeSource: the reader's storage boundary.

Everything the Spatial Parquet reader needs from storage is positional range
reads — the footer probe and one ``readinto`` per coalesced run of blobs.
:class:`ByteRangeSource` names exactly that contract so the same read path
runs against a local file (:class:`LocalFileSource`, byte-identical to the
historical ``seek``+``readinto`` behaviour) or an object-store-style backend
(:class:`~repro_torch.io.remote.RemoteRangeSource`: range GETs with retry/backoff,
timeouts, bounded concurrency and a read-through block cache).

Sources also keep a :class:`SourceStats` account (requests, retries,
timeouts, cache hits/misses) that the reader folds into its ``ReadStats`` so
every recovery is observable from the query result.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Protocol, runtime_checkable


@dataclass
class SourceStats:
    """Monotonic I/O counters of one source (mergeable / deltable)."""

    requests: int = 0       # range fetches attempted (incl. failed attempts)
    retries: int = 0        # failed attempts that were retried
    timeouts: int = 0       # attempts dropped for exceeding the deadline
    cache_hits: int = 0     # block-cache hits (remote sources)
    cache_misses: int = 0   # block-cache misses
    bytes_fetched: int = 0  # payload bytes successfully fetched

    def copy(self) -> "SourceStats":
        return SourceStats(**self.__dict__)

    def __add__(self, other: "SourceStats") -> "SourceStats":
        return SourceStats(**{
            k: getattr(self, k) + getattr(other, k) for k in self.__dict__
        })

    def __sub__(self, other: "SourceStats") -> "SourceStats":
        return SourceStats(**{
            k: getattr(self, k) - getattr(other, k) for k in self.__dict__
        })


@runtime_checkable
class ByteRangeSource(Protocol):
    """Positional range reads over one stored object (file or remote blob).

    Implementations must be safe for the reader's double-buffered use: at
    most one thread issues reads at a time per reader, but readers built on
    the same source from multiple scanner workers are not supported — each
    shard open creates its own source.
    """

    stats: SourceStats

    def size(self) -> int:
        """Total byte length of the object."""
        ...

    def readinto_at(self, offset: int, buf) -> int:
        """Fill ``buf`` with bytes starting at ``offset``; returns the count
        actually read (short only at end-of-object or on truncation)."""
        ...

    def read_at(self, offset: int, nbytes: int, *, refresh: bool = False) -> bytes:
        """Read ``nbytes`` at ``offset``. ``refresh=True`` bypasses (and
        heals) any caching layer — the reader uses it to re-fetch a blob
        whose checksum failed."""
        ...

    def close(self) -> None: ...


class LocalFileSource:
    """Local filesystem source: the historical reader behaviour, verbatim.

    ``readinto_at`` is one ``seek`` + one ``readinto`` — the reader's
    single-syscall-per-merged-run contract — and ``read_at`` is ``seek`` +
    ``read``, exactly what ``SpatialParquetReader`` did before the storage
    boundary existed. Byte-identical results, identical syscall counts.
    """

    def __init__(self, path):
        self.path = str(path)
        self._fh = open(self.path, "rb")
        self.stats = SourceStats()
        self._closed = False

    def size(self) -> int:
        return os.fstat(self._fh.fileno()).st_size

    def readinto_at(self, offset: int, buf) -> int:
        self._fh.seek(offset)
        self.stats.requests += 1
        got = self._fh.readinto(buf)
        self.stats.bytes_fetched += int(got or 0)
        return int(got or 0)

    def read_at(self, offset: int, nbytes: int, *, refresh: bool = False) -> bytes:
        # a local re-read IS the refresh: nothing is cached in this layer
        self._fh.seek(offset)
        self.stats.requests += 1
        out = self._fh.read(nbytes)
        self.stats.bytes_fetched += len(out)
        return out

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BytesSource:
    """In-memory source (tests / tiny objects); same contract, zero I/O."""

    def __init__(self, data: bytes, path: str = "<bytes>"):
        self.path = path
        self._data = bytes(data)
        self.stats = SourceStats()
        self._closed = False

    def size(self) -> int:
        return len(self._data)

    def readinto_at(self, offset: int, buf) -> int:
        chunk = self._data[offset : offset + len(buf)]
        view = memoryview(buf)
        view[: len(chunk)] = chunk
        self.stats.requests += 1
        self.stats.bytes_fetched += len(chunk)
        return len(chunk)

    def read_at(self, offset: int, nbytes: int, *, refresh: bool = False) -> bytes:
        self.stats.requests += 1
        out = self._data[offset : offset + nbytes]
        self.stats.bytes_fetched += len(out)
        return out

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_source(path_or_source) -> ByteRangeSource:
    """Coerce a path (str / PathLike) or ready source to a ByteRangeSource."""
    if isinstance(path_or_source, (str, os.PathLike)):
        return LocalFileSource(path_or_source)
    if isinstance(path_or_source, (bytes, bytearray, memoryview)):
        return BytesSource(bytes(path_or_source))
    if hasattr(path_or_source, "read_at"):
        return path_or_source
    raise TypeError(
        f"expected a path or ByteRangeSource, got {type(path_or_source).__name__}"
    )
