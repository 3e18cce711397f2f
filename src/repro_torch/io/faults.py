"""In-process range-GET server with deterministic fault injection.

:class:`InProcessRangeServer` speaks the object-store subset the remote
source needs — ``get(offset, length) -> (status, body)`` — over a local file
or bytes, with an explicit, deterministic fault schedule. It exists so the
whole fault matrix (truncated responses, transient 5xx, stalled reads,
bit-flipped payloads) is exercised in ordinary unit tests with zero sockets
and zero nondeterminism: faults fire on exact request indices or byte
ranges, burn down a ``times`` budget, then heal.

The request log (offset, length, status per request) makes assertions about
retry behaviour — *which* ranges were re-fetched, how many attempts — exact
rather than statistical.

Write-path crash points
-----------------------

The read path's faults model a flaky *server*; the write path's model a
dying *writer*. :func:`maybe_crash` is compiled into the durable-write /
catalog commit sequence at named points (shard emission, pre-rename,
post-rename, mid-compaction, mid-GC). Arming a point
(:func:`arm_crash` / :func:`crash_injection`) makes the next ``times``
passages raise :class:`InjectedCrash` — a ``BaseException``, so ordinary
``except Exception`` cleanup handlers do *not* run, exactly like a process
kill: whatever is on disk at that instant is what a reopen must cope with.
A point armed with ``truncate_to`` / ``truncate_frac`` first tears the file
whose path the call site passes (a partially-flushed shard), then crashes.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import NamedTuple


class RangeResponse(NamedTuple):
    status: int  # HTTP-style: 206 partial content, 5xx transient, 4xx fatal
    body: bytes


# fault kinds
FAULT_TRUNCATE = "truncate"  # drop trailing bytes of the response body
FAULT_ERROR = "error"        # status-only failure (503 by default)
FAULT_STALL = "stall"        # sleep before responding (client deadline trips)
FAULT_CORRUPT = "corrupt"    # bit-flip one payload byte (checksums catch it)


@dataclass
class FaultSpec:
    """One deterministic fault: *what* goes wrong, *when*, *how often*.

    ``times`` is the burn-down budget: the fault fires on its first
    ``times`` matching requests, then the server heals (``times=None``
    never heals — the permanent-corruption case). Matching is by request
    index (``match_request``, 0-based position in the server's lifetime
    request sequence) and/or byte overlap (``match_offset`` = [lo, hi)
    half-open range); with neither, every request matches.
    """

    kind: str
    times: int | None = 1
    status: int = 503            # for FAULT_ERROR
    delay: float = 0.0           # for FAULT_STALL, seconds
    drop_bytes: int = 1          # for FAULT_TRUNCATE
    flip_at: int = 0             # for FAULT_CORRUPT: byte index into the body
    match_request: int | None = None
    match_offset: tuple[int, int] | None = None

    def matches(self, request_i: int, offset: int, length: int) -> bool:
        if self.times is not None and self.times <= 0:
            return False
        if self.match_request is not None and request_i != self.match_request:
            return False
        if self.match_offset is not None:
            lo, hi = self.match_offset
            if offset >= hi or offset + length <= lo:
                return False
        return True


@dataclass
class RequestRecord:
    offset: int
    length: int
    status: int
    nbytes: int        # body bytes actually returned
    fault: str | None  # fault kind applied, if any


class InProcessRangeServer:
    """Serve range GETs from a file/bytes, applying a fault schedule.

    Not a socket server: calls happen on the caller's thread (stalls are a
    real ``time.sleep``, so keep injected delays small). ``get`` is safe to
    call from the remote source's fetch pool; the fault schedule and request
    log are guarded by the GIL-atomicity of list/attr ops plus the fact that
    deterministic tests drive one logical read at a time.
    """

    def __init__(self, data, faults: list[FaultSpec] | None = None,
                 *, latency: float = 0.0):
        if isinstance(data, (bytes, bytearray, memoryview)):
            self._data = bytes(data)
            self.path = "<bytes>"
        else:
            self.path = str(data)
            with open(self.path, "rb") as fh:
                self._data = fh.read()
        self.faults: list[FaultSpec] = list(faults or [])
        self.latency = float(latency)
        self.requests: list[RequestRecord] = []

    # ---------------------------------------------------------------- server
    def size(self) -> int:
        return len(self._data)

    def get(self, offset: int, length: int) -> RangeResponse:
        """One range GET. Applies the first matching active fault."""
        request_i = len(self.requests)
        if self.latency:
            time.sleep(self.latency)
        body = self._data[offset : offset + length]
        fault = None
        for f in self.faults:
            if f.matches(request_i, offset, length):
                fault = f
                if f.times is not None:
                    f.times -= 1
                break
        status = 206
        if fault is not None:
            if fault.kind == FAULT_ERROR:
                status, body = fault.status, b""
            elif fault.kind == FAULT_TRUNCATE:
                body = body[: max(0, len(body) - fault.drop_bytes)]
            elif fault.kind == FAULT_STALL:
                time.sleep(fault.delay)
            elif fault.kind == FAULT_CORRUPT:
                if len(body):
                    i = min(fault.flip_at, len(body) - 1)
                    mutated = bytearray(body)
                    mutated[i] ^= 0xFF
                    body = bytes(mutated)
            else:
                raise ValueError(f"unknown fault kind {fault.kind!r}")
        self.requests.append(RequestRecord(
            offset=offset, length=length, status=status, nbytes=len(body),
            fault=fault.kind if fault else None,
        ))
        return RangeResponse(status, body)

    # ------------------------------------------------------------ test hooks
    @property
    def n_requests(self) -> int:
        return len(self.requests)

    def n_faulted(self, kind: str | None = None) -> int:
        """How many served requests had a fault applied (optionally by kind)."""
        return sum(
            1 for r in self.requests
            if r.fault is not None and (kind is None or r.fault == kind)
        )


# --------------------------------------------------------------------------
# write-path crash points
# --------------------------------------------------------------------------

# canonical point names, in write-pipeline order
CRASH_SHARD_TORN = "writer.shard.torn"          # shard file flushed (maybe torn)
CRASH_COMMIT_PRE_RENAME = "catalog.commit.pre_rename"    # snap tmp written
CRASH_COMMIT_POST_RENAME = "catalog.commit.post_rename"  # snap live, HEAD stale
CRASH_COMPACT_MID = "catalog.compact.mid"       # merged shards written, no commit
CRASH_GC_MID = "catalog.gc.mid"                 # first orphan deleted, rest not

CRASH_POINTS = (
    CRASH_SHARD_TORN,
    CRASH_COMMIT_PRE_RENAME,
    CRASH_COMMIT_POST_RENAME,
    CRASH_COMPACT_MID,
    CRASH_GC_MID,
)


class InjectedCrash(BaseException):
    """Simulated hard kill at an armed crash point.

    Deliberately a ``BaseException``: ``except Exception`` cleanup code must
    not observe it, because a real ``kill -9`` would not have run that code
    either. Only the fault harness itself (tests) catches it.
    """

    def __init__(self, point: str):
        super().__init__(f"injected crash at {point!r}")
        self.point = point


@dataclass
class CrashSpec:
    """One armed crash point: fire the next ``times`` passages, then heal.

    ``truncate_to`` / ``truncate_frac`` tear the file the call site names
    before crashing (``truncate_frac`` keeps that fraction of the bytes),
    modelling a partially-flushed write.
    """

    point: str
    times: int = 1
    truncate_to: int | None = None
    truncate_frac: float | None = None


_crash_lock = threading.Lock()
_crash_specs: dict[str, CrashSpec] = {}


def arm_crash(point: str, *, times: int = 1, truncate_to: int | None = None,
              truncate_frac: float | None = None) -> CrashSpec:
    """Arm ``point``; the next ``times`` passages raise :class:`InjectedCrash`."""
    spec = CrashSpec(point, times=int(times), truncate_to=truncate_to,
                     truncate_frac=truncate_frac)
    with _crash_lock:
        _crash_specs[point] = spec
    return spec


def disarm_crashes() -> None:
    """Disarm every crash point (test teardown)."""
    with _crash_lock:
        _crash_specs.clear()


def crash_armed(point: str) -> bool:
    spec = _crash_specs.get(point)
    return spec is not None and spec.times > 0


def maybe_crash(point: str, path=None) -> None:
    """Fire ``point`` if armed: optionally tear ``path``, then raise.

    Unarmed points are a dict lookup — the production write path pays one
    ``dict.get`` per point, nothing else.
    """
    spec = _crash_specs.get(point)
    if spec is None:
        return
    with _crash_lock:
        if spec.times <= 0:
            return
        spec.times -= 1
    if path is not None and (spec.truncate_to is not None
                             or spec.truncate_frac is not None):
        size = os.path.getsize(path)
        keep = (spec.truncate_to if spec.truncate_to is not None
                else int(size * spec.truncate_frac))
        with open(path, "r+b") as fh:
            fh.truncate(max(0, min(size, keep)))
            fh.flush()
            os.fsync(fh.fileno())
    raise InjectedCrash(point)


class crash_injection:
    """``with crash_injection(point, ...):`` — arm on entry, disarm on exit.

    Swallows the :class:`InjectedCrash` for the armed point so the test
    body reads as "run this, crashing here"; any other exception (or a
    crash at a different point) propagates.
    """

    def __init__(self, point: str, **kwargs):
        self.point = point
        self.kwargs = kwargs
        self.crashed = False

    def __enter__(self):
        arm_crash(self.point, **self.kwargs)
        return self

    def __exit__(self, exc_type, exc, tb):
        disarm_crashes()
        if exc_type is InjectedCrash and exc.point == self.point:
            self.crashed = True
            return True
        return False
