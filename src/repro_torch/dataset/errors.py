"""Dataset-level error types: attributed failures for degraded-mode scans.

A lake-scale scan has two tiers of failure. The *catalog* tier — a missing,
malformed or partially-written ``manifest.json`` — is always fatal and
surfaces as :class:`DatasetError` with the offending path and field spelled
out (never a raw ``KeyError`` or ``JSONDecodeError``). The *shard* tier — a
single shard failing its reads even after the source's own retry/backoff —
is governed by the scanner's ``on_error`` policy: ``"raise"`` wraps the
cause in :class:`ShardReadError` (which names the shard), ``"retry"``
re-opens the shard up to ``shard_retries`` times before raising, and
``"skip"`` drops the shard from the result and records a
:class:`ShardFailure` in ``ReadStats.failures`` so callers can see exactly
what a degraded answer is missing.
"""

from __future__ import annotations

from dataclasses import dataclass


class DatasetError(RuntimeError):
    """A dataset catalog problem: missing/malformed/partial manifest."""


class CommitConflict(DatasetError):
    """A snapshot commit lost the generation race.

    The commit's target generation was taken by another writer between
    ``begin()`` and the rename; the loser's staged files are aborted (or
    left for GC) and the caller decides whether to rebase and retry.
    """


class ShardReadError(RuntimeError):
    """One shard of a dataset failed to read (cause chained).

    Carries the shard's manifest index and path so a multi-shard failure is
    attributable without re-running the scan.
    """

    def __init__(self, shard_index: int, path: str, cause: Exception):
        super().__init__(
            f"shard {shard_index} ({path}) failed: "
            f"{type(cause).__name__}: {cause}"
        )
        self.shard_index = int(shard_index)
        self.path = str(path)
        self.cause = cause


@dataclass
class ShardFailure:
    """Record of one shard skipped by an ``on_error="skip"`` scan."""

    shard_index: int
    path: str
    error_type: str
    message: str
    attempts: int

    @staticmethod
    def from_error(shard_index: int, path: str, exc: Exception,
                   attempts: int) -> "ShardFailure":
        return ShardFailure(
            shard_index=int(shard_index),
            path=str(path),
            error_type=type(exc).__name__,
            message=str(exc),
            attempts=int(attempts),
        )
