"""RemoteRangeSource: object-store-style range GETs, made survivable.

Models how the reader's coalesced-read contract maps onto a remote object
store: every ``readinto_at`` becomes block-aligned range GETs against a
*server* (anything with ``size()`` and ``get(offset, length) -> (status,
body)`` — an :class:`~repro_torch.io.faults.InProcessRangeServer` in tests, a real
HTTP range client behind the same two methods in production). On top of the
raw GET it layers exactly the machinery a data-lake client needs:

* **per-request deadline** — a response slower than ``timeout`` counts as a
  timeout and is retried (the stalled-read case);
* **retries with exponential backoff + deterministic jitter** — transient
  5xx, truncated bodies, transport exceptions and timeouts all retry up to
  ``max_retries`` times with ``backoff_base * 2^attempt`` sleeps (capped at
  ``backoff_max``), jittered by a seeded RNG so tests are reproducible;
  4xx responses are fatal immediately;
* **request coalescing** — consecutive missing cache blocks fetch as one
  range GET (capped by ``max_request_bytes``), mirroring the reader's own
  run merging one layer down;
* **bounded concurrency** — multiple missing runs fetch in parallel on a
  pool of at most ``max_concurrency`` threads;
* **read-through block cache** — an LRU of ``block_size`` blocks
  (``cache_blocks`` capacity) so re-scans of hot ranges skip the network;
  ``read_at(refresh=True)`` invalidates and re-fetches, which is how the
  reader heals a cache poisoned by a corrupt (checksum-failing) response.

Every recovery is counted in :class:`~repro_torch.io.source.SourceStats`; the
reader folds those into the query's ``ReadStats``.
"""

from __future__ import annotations

import random
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

from repro_torch import obs

from .source import SourceStats


class TransientServerError(IOError):
    """A retryable server response (5xx / truncated body / transport error)."""

    def __init__(self, msg: str, status: int | None = None):
        super().__init__(msg)
        self.status = status


class RangeRequestError(IOError):
    """A fatal (non-retryable) server response, e.g. 404/416."""

    def __init__(self, msg: str, status: int | None = None):
        super().__init__(msg)
        self.status = status


class RequestTimeout(TransientServerError):
    """The response missed the per-request deadline."""


class RetriesExhausted(IOError):
    """A range GET kept failing after every allowed retry.

    Attributed: carries the byte range, the attempt count and the last
    underlying error (also chained as ``__cause__``).
    """

    def __init__(self, offset: int, nbytes: int, attempts: int, last: Exception):
        super().__init__(
            f"range GET [{offset}, {offset + nbytes}) failed after "
            f"{attempts} attempts: {last}"
        )
        self.offset = int(offset)
        self.nbytes = int(nbytes)
        self.attempts = int(attempts)
        self.last_error = last


class RemoteRangeSource:
    """A ByteRangeSource over a range-GET server (see module docstring)."""

    def __init__(
        self,
        server,
        *,
        size: int | None = None,
        block_size: int = 256 * 1024,
        cache_blocks: int = 256,
        timeout: float = 1.0,
        max_retries: int = 4,
        backoff_base: float = 0.01,
        backoff_max: float = 0.25,
        jitter: float = 0.25,
        seed: int = 0,
        max_concurrency: int = 4,
        max_request_bytes: int = 8 << 20,
    ):
        self._server = server
        self._size = int(server.size() if size is None else size)
        self.block_size = int(block_size)
        self.cache_blocks = int(cache_blocks)
        self.timeout = float(timeout)
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self.jitter = float(jitter)
        self.max_concurrency = max(1, int(max_concurrency))
        self.max_request_bytes = max(self.block_size, int(max_request_bytes))
        self.path = getattr(server, "path", "<remote>")
        self.stats = SourceStats()
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._cache: OrderedDict[int, bytes] = OrderedDict()
        self._pool: ThreadPoolExecutor | None = None
        self._closed = False

    # ----------------------------------------------------------------- sizes
    def size(self) -> int:
        return self._size

    @property
    def closed(self) -> bool:
        return self._closed

    # ----------------------------------------------------------- fetch layer
    def _backoff_sleep(self, attempt: int) -> None:
        delay = min(self.backoff_max, self.backoff_base * (2.0 ** attempt))
        with self._lock:
            factor = 1.0 + self.jitter * self._rng.random()
        time.sleep(delay * factor)

    def _fetch_range(self, offset: int, nbytes: int) -> bytes:
        """One logical range GET with deadline + retry/backoff semantics."""
        last: Exception | None = None
        for attempt in range(self.max_retries + 1):
            self.stats.requests += 1
            t0 = time.monotonic()
            try:
                status, body = self._server.get(offset, nbytes)
            except Exception as exc:  # transport-level failure: retryable
                obs.observe("io.range_get_s", time.monotonic() - t0)
                last = TransientServerError(f"transport error: {exc!r}")
            else:
                elapsed = time.monotonic() - t0
                obs.observe("io.range_get_s", elapsed)
                if elapsed > self.timeout:
                    self.stats.timeouts += 1
                    last = RequestTimeout(
                        f"range GET [{offset}, {offset + nbytes}) exceeded "
                        f"deadline ({elapsed:.3f}s > {self.timeout:.3f}s)"
                    )
                elif status >= 500:
                    last = TransientServerError(
                        f"server returned {status} for range "
                        f"[{offset}, {offset + nbytes})", status=status)
                elif status in (200, 206):
                    if len(body) != nbytes:
                        last = TransientServerError(
                            f"truncated response: got {len(body)} of {nbytes} "
                            f"bytes at offset {offset}")
                    else:
                        self.stats.bytes_fetched += len(body)
                        obs.count("io.bytes_fetched", len(body))
                        return body
                else:
                    raise RangeRequestError(
                        f"server returned {status} for range "
                        f"[{offset}, {offset + nbytes})", status=status)
            if attempt == self.max_retries:
                raise RetriesExhausted(offset, nbytes, attempt + 1, last) from last
            self.stats.retries += 1
            obs.instant("io.retry", cat="io", offset=offset, nbytes=nbytes,
                        attempt=attempt, error=type(last).__name__)
            with obs.span("io.backoff", cat="io", attempt=attempt):
                self._backoff_sleep(attempt)
        raise AssertionError("unreachable")

    def _fetch_block_run(self, b0: int, b1: int) -> dict[int, bytes]:
        """Fetch blocks [b0, b1) in max_request_bytes-sized coalesced GETs."""
        bs = self.block_size
        got: dict[int, bytes] = {}
        blocks_per_req = max(1, self.max_request_bytes // bs)
        b = b0
        while b < b1:
            be = min(b1, b + blocks_per_req)
            off = b * bs
            nbytes = min(be * bs, self._size) - off
            body = self._fetch_range(off, nbytes)
            for i in range(b, be):
                lo = (i - b) * bs
                got[i] = body[lo : lo + bs]
            b = be
        return got

    def _require_blocks(self, b0: int, b1: int) -> dict[int, bytes]:
        """Return bytes of every block in [b0, b1), via cache or fetch."""
        got: dict[int, bytes] = {}
        runs: list[list[int]] = []
        with self._lock:
            for b in range(b0, b1):
                cached = self._cache.get(b)
                if cached is not None:
                    self._cache.move_to_end(b)
                    self.stats.cache_hits += 1
                    got[b] = cached
                else:
                    self.stats.cache_misses += 1
                    if runs and runs[-1][1] == b:
                        runs[-1][1] = b + 1
                    else:
                        runs.append([b, b + 1])
        if runs:
            # materialize every fetch BEFORE taking the lock: workers use it
            # for backoff jitter, so consuming lazily under it would deadlock
            if len(runs) > 1 and self.max_concurrency > 1:
                fetched = list(self._executor().map(
                    lambda r: self._fetch_block_run(r[0], r[1]), runs))
            else:
                fetched = [self._fetch_block_run(r0, r1) for r0, r1 in runs]
            with self._lock:
                for chunk in fetched:
                    got.update(chunk)
                    for b, data in chunk.items():
                        self._cache[b] = data
                        self._cache.move_to_end(b)
                    while len(self._cache) > self.cache_blocks:
                        self._cache.popitem(last=False)
        return got

    def _executor(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.max_concurrency,
                    thread_name_prefix="range-get",
                )
            return self._pool

    # ------------------------------------------------------------- read API
    def readinto_at(self, offset: int, buf) -> int:
        view = memoryview(buf)
        n = len(view)
        if n == 0 or offset >= self._size:
            return 0
        end = min(offset + n, self._size)
        bs = self.block_size
        b0, b1 = offset // bs, (end - 1) // bs + 1
        blocks = self._require_blocks(b0, b1)
        w = 0
        for b in range(b0, b1):
            data = blocks[b]
            lo = offset - b * bs if b == b0 else 0
            hi = end - b * bs if b == b1 - 1 else len(data)
            chunk = data[lo:hi]
            view[w : w + len(chunk)] = chunk
            w += len(chunk)
        return w

    def read_at(self, offset: int, nbytes: int, *, refresh: bool = False) -> bytes:
        if refresh:
            self.invalidate(offset, nbytes)
        avail = max(0, min(nbytes, self._size - offset))
        buf = bytearray(avail)
        got = self.readinto_at(offset, buf)
        return bytes(buf[:got])

    def invalidate(self, offset: int, nbytes: int) -> None:
        """Drop cached blocks overlapping [offset, offset + nbytes)."""
        if nbytes <= 0:
            return
        bs = self.block_size
        b0, b1 = offset // bs, (offset + nbytes - 1) // bs + 1
        with self._lock:
            for b in range(b0, b1):
                self._cache.pop(b, None)

    # ------------------------------------------------------------- lifecycle
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)
        self._cache.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
