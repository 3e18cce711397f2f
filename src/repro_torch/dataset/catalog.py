"""Crash-safe transactional catalog: snapshot-isolated dataset commits.

The I/O layer makes the *read* path survive a flaky store; this module
makes the *write* path survive a dying writer. Every dataset mutation is an atomic
commit of a new **snapshot** file::

    lake/
      shard-00000.spqf                     # generation 1 data files
      shard-g000002-4f9a01c2-00000.spqf    # files of later generations
      snap-0000000001.json        # snapshot: shard entries + MBRs + CRCs
      snap-0000000002.json
      HEAD                        # pointer hint (healed on open)
      manifest.json               # legacy mirror of the newest snapshot

A snapshot lists the shard entries (paths, MBRs, whole-file CRC-32Cs) of one
immutable version of the dataset. Commits follow temp-file + fsync +
exclusive-link discipline, so the *appearance of the snapshot file is the
commit point*: a crash anywhere before it leaves the previous generation
intact (new files are unreferenced orphans); a crash anywhere after it
leaves the new generation discoverable by the highest-generation rule even
when the ``HEAD`` hint / ``manifest.json`` mirror are stale (both are
healed on the next :meth:`Catalog.open`). The commit point is
``os.link``-ing the fsynced temp file to ``snap-<gen>.json`` — an
exclusive create, so when two *processes* race the same generation exactly
one link succeeds and the loser gets :class:`CommitConflict` instead of
silently overwriting the winner's snapshot.

Every transaction stages its shard files under names carrying a random
per-transaction token (``shard-g<gen>-<token>-<i>.spqf``), so racing
writers — even across processes — never share staged filenames: the CAS
loser's :meth:`CommitTx.abort` only ever unlinks files it exclusively
owns. In-flight staged names are also registered per root and excluded
from :meth:`Catalog.gc`, so an explicit GC racing a live commit cannot
collect files the about-to-commit snapshot references.

Readers call :meth:`Catalog.pin` to hold a generation: pinned generations
(and their shard files) are exempt from :meth:`Catalog.gc`, so a scan keeps
a consistent view while the background :class:`Compactor` merges
small adjacent shards into new-generation files and commits the result.
Shards are SFC-ordered within the manifest, and the compactor only ever
merges *adjacent* runs, so the concatenation order of records — and
therefore every full scan and every ``refine=True`` bbox scan — is
bit-identical across compaction.

Shards are written through :func:`repro_torch.core.writer.write_file` and
read back (by the compactor) through
:class:`~repro_torch.core.reader.SpatialParquetReader`, both on the
``device`` they are given: ``"cuda"`` (the default) runs the float32
zone-stats and read kernels on the card, ``"cpu"`` their plain versions.
The bytes written are the same either way.

Pins are in-process (a module-level registry shared by every ``Catalog``
instance on the same directory). Cross-process readers are protected by the
``keep_snapshots`` retention window instead.

The write-path crash points exercised by the differential fault suite live
in :mod:`repro_torch.io.faults` (``CRASH_SHARD_TORN``, ``CRASH_COMMIT_PRE_RENAME``,
``CRASH_COMMIT_POST_RENAME``, ``CRASH_COMPACT_MID``, ``CRASH_GC_MID``).
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import uuid

import numpy as np

from repro_torch import obs
from repro_torch._device import torch_device
from repro_torch.core.reader import (
    SpatialParquetReader,
    footer_data_bytes,
    footer_page_count,
)
from repro_torch.core.writer import concat_columns, write_file
from repro_torch.io.checksum import crc32c
from repro_torch.io.durable import fsync_dir, fsync_file, is_tmp_name, tmp_name_for, write_atomic
from repro_torch.io.faults import (
    CRASH_COMMIT_POST_RENAME,
    CRASH_COMMIT_PRE_RENAME,
    CRASH_COMPACT_MID,
    CRASH_GC_MID,
    CRASH_SHARD_TORN,
    maybe_crash,
)

from .errors import CommitConflict, DatasetError
from .manifest import MANIFEST_NAME, DatasetManifest, ShardInfo, shard_path

SNAPSHOT_FORMAT = "spatial-parquet-snapshot"
SNAPSHOT_VERSION = 1
SNAP_NAME = "snap-{:010d}.json"
HEAD_NAME = "HEAD"
HEAD_FORMAT = "spatial-parquet-head"

_SNAP_RE = re.compile(r"^snap-(\d{1,19})\.json$")
_SHARD_RE = re.compile(r"^shard-(?:g\d{6}-(?:[0-9a-f]{8}-)?)?\d{5}\.spqf$")

# in-process, cross-instance state per dataset root (realpath-keyed):
# one reentrant lock serializing {commit-link, pin, gc} critical sections,
# the pin refcounts GC consults, and the staged filenames of in-flight
# transactions (GC must not collect a live commit's not-yet-referenced files)
_registry_lock = threading.Lock()
_root_locks: dict[str, threading.RLock] = {}
_root_pins: dict[str, dict[int, int]] = {}
_root_inflight: dict[str, dict[int, set[str]]] = {}


def _root_key(root) -> str:
    return os.path.realpath(str(root))


def _root_lock(root) -> threading.RLock:
    key = _root_key(root)
    with _registry_lock:
        lock = _root_locks.get(key)
        if lock is None:
            lock = _root_locks[key] = threading.RLock()
        return lock


def pinned_generations(root) -> set[int]:
    """Generations currently pinned (by any in-process reader) for ``root``."""
    key = _root_key(root)
    with _registry_lock:
        return {g for g, n in _root_pins.get(key, {}).items() if n > 0}


def inflight_names(root) -> set[str]:
    """Filenames staged by live in-process transactions on ``root`` (GC
    treats these as referenced even though no snapshot lists them yet)."""
    key = _root_key(root)
    with _registry_lock:
        out: set[str] = set()
        for names in _root_inflight.get(key, {}).values():
            out |= names
        return out


def file_crc32c(path, chunk: int = 1 << 20) -> int:
    """Whole-file CRC-32C, streamed (the snapshot's per-shard integrity tag)."""
    value = 0
    with open(str(path), "rb") as fh:
        while True:
            block = fh.read(chunk)
            if not block:
                return value
            value = crc32c(block, value)


class Snapshot:
    """One immutable committed version of the dataset."""

    __slots__ = ("generation", "parent", "manifest", "path")

    def __init__(self, generation: int, parent: int | None,
                 manifest: DatasetManifest, path: str | None):
        self.generation = int(generation)
        self.parent = parent
        self.manifest = manifest
        self.path = path  # snapshot file; None only for legacy generation 0

    def __repr__(self) -> str:
        return (f"Snapshot(gen={self.generation}, "
                f"shards={self.manifest.n_shards}, "
                f"records={self.manifest.n_records})")


class PinnedSnapshot:
    """A refcounted hold on one generation; release it (or use as a context
    manager) when the scan is done so GC can reclaim superseded files."""

    def __init__(self, catalog: "Catalog", snapshot: Snapshot):
        self._catalog = catalog
        self.snapshot = snapshot
        self._released = False

    @property
    def generation(self) -> int:
        return self.snapshot.generation

    @property
    def manifest(self) -> DatasetManifest:
        return self.snapshot.manifest

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._catalog._unpin(self.generation)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()

    def __repr__(self) -> str:
        state = "released" if self._released else "held"
        return f"PinnedSnapshot(gen={self.generation}, {state})"


class CommitTx:
    """One staged commit: new shard files + the atomic snapshot rename.

    Obtained from :meth:`Catalog.begin`; stage shard files with
    :meth:`stage_shard`, then :meth:`commit` a manifest listing staged and/or
    carried-over entries. On failure call :meth:`abort` to delete staged
    files — except after :class:`~repro_torch.io.faults.InjectedCrash`, which is a
    ``BaseException`` precisely so ordinary cleanup does not run and the
    orphans are left for :meth:`Catalog.gc`, like a real kill.
    """

    def __init__(self, catalog: "Catalog", parent_gen: int):
        self.catalog = catalog
        self.parent_gen = int(parent_gen)
        self.generation = max(1, self.parent_gen + 1)
        self.staged: list[str] = []  # root-relative filenames written by us
        self._n = 0
        self._done = False
        # per-transaction token: staged filenames are unique even when two
        # transactions race the same parent generation (writer vs compactor),
        # so abort() only ever unlinks files this transaction owns
        self.token = uuid.uuid4().hex[:8]
        self._protected: set[str] = set()  # names GC must leave alone
        key = _root_key(catalog.root)
        with _registry_lock:
            inflight = _root_inflight.setdefault(key, {})
            # a concurrent creator of the same virgin directory forfeits the
            # historical plain names, keeping initial commits collision-free
            self._contended = bool(inflight)
            inflight[id(self)] = self._protected

    # --------------------------------------------------------------- staging
    def shard_filename(self, i: int | None = None) -> str:
        """Unique filename for the ``i``-th new shard of this generation.

        Generation 1 of a virgin directory keeps the historical plain names
        (``shard-00000.spqf``) when no other transaction is in flight; any
        other commit gets generation- and transaction-qualified names
        (``shard-g000002-<token>-00000.spqf``) so neither live files nor a
        concurrent transaction's staged files are ever overwritten.
        """
        if i is None:
            i, self._n = self._n, self._n + 1
        if self.parent_gen < 0 and not self._contended:
            return f"shard-{i:05d}.spqf"
        return f"shard-g{self.generation:06d}-{self.token}-{i:05d}.spqf"

    def _protect(self, name: str) -> None:
        with _registry_lock:
            self._protected.add(name)

    def _forsake(self) -> None:
        """Drop this transaction's in-flight GC protection (idempotent).

        Called when the transaction completes, aborts, or dies — including
        via :class:`~repro_torch.io.faults.InjectedCrash`, because the registry is
        process memory a real kill would have taken with it; the files on
        disk become ordinary orphans for :meth:`Catalog.gc`.
        """
        key = _root_key(self.catalog.root)
        with _registry_lock:
            txs = _root_inflight.get(key)
            if txs is not None:
                txs.pop(id(self), None)
                if not txs:
                    _root_inflight.pop(key, None)

    def stage_shard(self, cols, extras=None, *, fsync: bool = True,
                    device="cuda", **file_kwargs) -> ShardInfo:
        """Write one shard file for this commit and return its entry.

        The file is written to its final (unique) name, optionally torn by
        the ``CRASH_SHARD_TORN`` fault point, fsynced, and CRC'd — it only
        becomes reachable when :meth:`commit` renames the snapshot in.
        ``device`` is where the writer reduces float32 zone stats.
        """
        name = self.shard_filename()
        path = os.path.join(self.catalog.root, name)
        # registered before the write so abort() also cleans a file that
        # write_file itself left half-written when it raised, and so a
        # concurrent gc() never collects it out from under this commit
        self.staged.append(name)
        self._protect(name)
        try:
            footer = write_file(path, columns=cols, extra=extras or None,
                                sort=None, device=device, **file_kwargs)
            maybe_crash(CRASH_SHARD_TORN, path=path)
            if fsync:
                with open(path, "rb") as fh:
                    os.fsync(fh.fileno())
            info = ShardInfo(
                path=name,
                mbr=_mbr_of(cols),
                n_records=cols.n_records,
                n_values=cols.n_values,
                n_pages=footer_page_count(footer),
                data_bytes=footer_data_bytes(footer),
                file_bytes=os.path.getsize(path),
                crc32c=file_crc32c(path),
                zone_maps=zone_maps_from_footer(footer),
            )
        except BaseException:
            # the transaction is dead: drop its GC protection (a real kill
            # would have lost this process state too); the files stay on
            # disk for abort() or Catalog.gc() to reclaim
            self._forsake()
            raise
        return info

    # ---------------------------------------------------------------- commit
    def commit(self, manifest: DatasetManifest, *, fsync: bool = True,
               gc: bool | None = None) -> Snapshot:
        """Atomically publish ``manifest`` as generation ``self.generation``.

        Protocol: snapshot JSON → same-dir temp file → fsync →
        [``CRASH_COMMIT_PRE_RENAME``] → CAS check under the root lock →
        ``os.link`` of the temp onto ``snap-<gen>.json`` (THE commit point:
        an exclusive create, so a same-generation committer in another
        process fails instead of overwriting) → dir fsync →
        [``CRASH_COMMIT_POST_RENAME``] → HEAD + ``manifest.json`` mirror
        (each atomic) → GC of superseded, unpinned generations.

        Raises :class:`CommitConflict` if another writer took this
        generation first — detected by the head CAS for in-process races
        and by the exclusive link for cross-process ones; the dataset is
        untouched in that case. (On filesystems without hard links the
        commit falls back to ``os.replace`` behind an existence check,
        where same-generation exclusion is in-process only.)
        """
        if self._done:
            raise DatasetError("commit transaction already completed")
        cat = self.catalog
        t0 = time.perf_counter()
        snap_dict = {
            "format": SNAPSHOT_FORMAT,
            "version": SNAPSHOT_VERSION,
            "generation": self.generation,
            "parent": self.parent_gen if self.parent_gen >= 0 else None,
            "manifest": manifest.to_dict(),
        }
        data = (json.dumps(snap_dict, indent=1) + "\n").encode()
        snap_file = os.path.join(cat.root, SNAP_NAME.format(self.generation))
        try:
            with obs.span("catalog.commit", gen=self.generation,
                          shards=manifest.n_shards):
                fd, tmp = tmp_name_for(snap_file)
                self._protect(os.path.basename(tmp))
                with os.fdopen(fd, "wb") as fh:
                    fh.write(data)
                    if fsync:
                        fsync_file(fh)
                maybe_crash(CRASH_COMMIT_PRE_RENAME)
                with _root_lock(cat.root):
                    try:
                        if cat.head_generation() != self.parent_gen:
                            raise CommitConflict(
                                f"{cat.root}: generation {self.generation} "
                                f"was committed by another writer (head "
                                f"moved past {self.parent_gen})")
                        self._publish(tmp, snap_file)
                    except Exception:
                        try:
                            os.unlink(tmp)
                        except OSError:
                            pass
                        raise
                    if fsync:
                        fsync_dir(cat.root)
                    snapshot = Snapshot(self.generation, snap_dict["parent"],
                                        manifest, snap_file)
                    cat._snap_cache[self.generation] = snapshot
                    self._done = True
                    maybe_crash(CRASH_COMMIT_POST_RENAME)
                    cat._write_head(self.generation, fsync=fsync)
                    manifest.save(cat.root, fsync=fsync)
                    # committed: the head snapshot now references the staged
                    # files, so ordinary retention protects them from here on
                    self._forsake()
                    if gc if gc is not None else cat.auto_gc:
                        cat.gc(fsync=fsync)
        except BaseException:
            self._forsake()
            raise
        obs.count("catalog.commits")
        obs.observe("catalog.commit_s", time.perf_counter() - t0)
        return snapshot

    def _publish(self, tmp: str, snap_file: str) -> None:
        """Make ``tmp`` visible as ``snap_file`` — the commit point.

        ``os.link`` refuses to clobber an existing file, so exactly one of
        two processes racing the same generation number commits; the loser
        surfaces as :class:`CommitConflict` with its temp cleaned up by the
        caller.
        """
        try:
            os.link(tmp, snap_file)
        except FileExistsError:
            raise CommitConflict(
                f"{snap_file}: generation {self.generation} was committed "
                f"by another process") from None
        except OSError:
            # hard links unsupported here: atomic rename keeps crash safety,
            # same-generation exclusion degrades to the in-process CAS
            if os.path.exists(snap_file):
                raise CommitConflict(
                    f"{snap_file}: generation {self.generation} was "
                    f"committed by another process") from None
            os.replace(tmp, snap_file)
            return
        try:
            os.unlink(tmp)  # second hard link; the snapshot itself stays
        except OSError:
            pass

    def abort(self) -> None:
        """Delete staged shard files (ordinary-failure cleanup path).

        Staged names are transaction-unique, so this only ever unlinks
        files this transaction wrote — never a racing winner's.
        """
        if self._done:
            return
        self._done = True
        for name in self.staged:
            try:
                os.unlink(os.path.join(self.catalog.root, name))
            except OSError:
                pass
        self.staged.clear()
        self._forsake()

    def __del__(self):
        try:  # abandoned tx: do not hold GC protection for the process life
            self._forsake()
        except Exception:
            pass


class Catalog:
    """The versioned catalog of one dataset directory.

    ``keep_snapshots`` is the retention window: GC keeps that many of the
    newest generations (plus anything pinned in-process), so slightly-stale
    external readers survive a commit. ``auto_gc=False`` defers all orphan
    collection to explicit :meth:`gc` calls.
    """

    def __init__(self, root, *, keep_snapshots: int = 2, auto_gc: bool = True,
                 create: bool = False):
        self.root = str(root)
        self.keep_snapshots = max(1, int(keep_snapshots))
        self.auto_gc = bool(auto_gc)
        self._snap_cache: dict[int, Snapshot] = {}
        if not os.path.isdir(self.root):
            if not create:
                raise DatasetError(
                    f"{self.root}: not a directory (pass create=True to "
                    f"make a new dataset root)")
            os.makedirs(self.root, exist_ok=True)
        if create is False and self.head_generation() < 0:
            raise DatasetError(
                f"{os.path.join(self.root, MANIFEST_NAME)}: no manifest "
                f"found (not a dataset directory?)")
        self._heal()

    @classmethod
    def open(cls, root, **kwargs) -> "Catalog":
        return cls(root, **kwargs)

    # ------------------------------------------------------------- discovery
    def list_generations(self) -> list[int]:
        """Committed snapshot generations on disk, ascending (no legacy 0)."""
        gens = []
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return []
        for name in names:
            m = _SNAP_RE.match(name)
            if m:
                gens.append(int(m.group(1)))
        return sorted(gens)

    def head_generation(self) -> int:
        """Newest committed generation: highest ``snap-*.json`` wins; a
        snapshot-less directory with a legacy ``manifest.json`` is
        generation 0; a virgin directory is -1."""
        gens = self.list_generations()
        if gens:
            return gens[-1]
        if os.path.isfile(os.path.join(self.root, MANIFEST_NAME)):
            return 0
        return -1

    def head_snapshot(self) -> Snapshot:
        gen = self.head_generation()
        if gen < 0:
            raise DatasetError(
                f"{os.path.join(self.root, MANIFEST_NAME)}: no manifest "
                f"found (not a dataset directory?)")
        return self.load_snapshot(gen)

    def load_snapshot(self, generation: int) -> Snapshot:
        """Load + validate one committed snapshot (cached; immutable once
        committed). Generation 0 is the legacy ``manifest.json``."""
        generation = int(generation)
        snap = self._snap_cache.get(generation)
        if snap is not None:
            return snap
        if generation == 0:
            manifest = DatasetManifest.load(self.root)
            snap = Snapshot(0, None, manifest, None)
        else:
            path = os.path.join(self.root, SNAP_NAME.format(generation))
            try:
                with open(path) as fh:
                    d = json.load(fh)
            except FileNotFoundError:
                raise DatasetError(
                    f"{path}: snapshot {generation} not found "
                    f"(GC'd or never committed?)") from None
            except json.JSONDecodeError as exc:
                raise DatasetError(
                    f"{path}: snapshot is not valid JSON: {exc}") from exc
            except OSError as exc:
                raise DatasetError(
                    f"{path}: cannot read snapshot: {exc}") from exc
            if not isinstance(d, dict) or d.get("format") != SNAPSHOT_FORMAT:
                raise DatasetError(
                    f"{path}: not a {SNAPSHOT_FORMAT} file "
                    f"(format={d.get('format') if isinstance(d, dict) else d!r})")
            version = d.get("version", 0)
            if not isinstance(version, int) or version > SNAPSHOT_VERSION:
                raise DatasetError(
                    f"{path}: snapshot version {version!r} is newer than "
                    f"this library understands (<= {SNAPSHOT_VERSION})")
            if d.get("generation") != generation:
                raise DatasetError(
                    f"{path}: snapshot declares generation "
                    f"{d.get('generation')!r}, filename says {generation}")
            manifest = DatasetManifest.from_dict(
                d.get("manifest"), where=path)
            snap = Snapshot(generation, d.get("parent"), manifest, path)
        self._snap_cache[generation] = snap
        return snap

    # --------------------------------------------------------------- pinning
    def pin(self, generation: int | None = None) -> PinnedSnapshot:
        """Pin a generation (default: the current head) against GC.

        Atomic with respect to commits and GC on this root: the returned
        snapshot's files cannot be collected until release.
        """
        key = _root_key(self.root)
        with _root_lock(self.root):
            gen = self.head_generation() if generation is None else int(generation)
            if gen < 0:
                raise DatasetError(
                    f"{self.root}: nothing to pin (empty dataset root)")
            snap = self.load_snapshot(gen)
            with _registry_lock:
                pins = _root_pins.setdefault(key, {})
                pins[gen] = pins.get(gen, 0) + 1
        return PinnedSnapshot(self, snap)

    def _unpin(self, generation: int) -> None:
        key = _root_key(self.root)
        with _registry_lock:
            pins = _root_pins.get(key)
            if pins is None:
                return
            n = pins.get(generation, 0) - 1
            if n <= 0:
                pins.pop(generation, None)
            else:
                pins[generation] = n

    # ---------------------------------------------------------------- commit
    def begin(self) -> CommitTx:
        """Start a commit on top of the current head (CAS'd at commit)."""
        return CommitTx(self, self.head_generation())

    def commit_manifest(self, manifest: DatasetManifest, *,
                        fsync: bool = True, gc: bool | None = None) -> Snapshot:
        """Metadata-only commit: publish ``manifest`` (whose shard entries
        all reference existing files) as a new generation."""
        return self.begin().commit(manifest, fsync=fsync, gc=gc)

    # -------------------------------------------------------------------- GC
    def orphans(self) -> list[str]:
        """Filenames GC would delete right now (dry run)."""
        with _root_lock(self.root):
            return self._gc_scan()[0]

    def gc(self, *, fsync: bool = True) -> dict:
        """Delete unreferenced files: shards of collected generations,
        snapshots outside the retention window, temp files of interrupted
        writes. Pinned generations and the head are always retained; only
        filename shapes this catalog writes are ever touched.
        """
        t0 = time.perf_counter()
        with obs.span("catalog.gc"), _root_lock(self.root):
            doomed, retained_gens = self._gc_scan()
            deleted = []
            bytes_reclaimed = 0
            for name in doomed:
                path = os.path.join(self.root, name)
                try:
                    size = os.path.getsize(path)
                    os.unlink(path)
                except OSError:
                    continue
                gen = _SNAP_RE.match(name)
                if gen:
                    self._snap_cache.pop(int(gen.group(1)), None)
                deleted.append(name)
                bytes_reclaimed += size
                maybe_crash(CRASH_GC_MID)
            if deleted and fsync:
                fsync_dir(self.root)
        obs.count("catalog.gc_deleted_files", len(deleted))
        obs.count("catalog.gc_bytes_reclaimed", bytes_reclaimed)
        obs.observe("catalog.gc_s", time.perf_counter() - t0)
        return {
            "deleted": deleted,
            "bytes_reclaimed": bytes_reclaimed,
            "retained_generations": sorted(retained_gens),
        }

    def _gc_scan(self) -> tuple[list[str], set[int]]:
        """(doomed filenames, retained generations) — caller holds the lock."""
        gens = self.list_generations()
        head = self.head_generation()
        retained = set(gens[-self.keep_snapshots:])
        if head >= 0:
            retained.add(head)
        retained |= {g for g in pinned_generations(self.root)
                     if g == 0 or g in set(gens)}
        # files staged by live in-flight commits are not yet referenced by
        # any snapshot but must survive a concurrent explicit gc(): the
        # commit may still succeed and publish a snapshot naming them
        live_files: set[str] = {MANIFEST_NAME, HEAD_NAME}
        live_files |= inflight_names(self.root)
        for gen in retained:
            try:
                snap = self.load_snapshot(gen)
            except DatasetError:
                continue
            for s in snap.manifest.shards:
                live_files.add(s.path)
        doomed = []
        for name in sorted(os.listdir(self.root)):
            if name in live_files:
                continue
            m = _SNAP_RE.match(name)
            if m:
                if int(m.group(1)) not in retained:
                    doomed.append(name)
                continue
            if is_tmp_name(name):
                doomed.append(name)
                continue
            if _SHARD_RE.match(name):
                doomed.append(name)  # unreferenced by any retained snapshot
        return doomed, retained

    # ------------------------------------------------------------------ heal
    def _write_head(self, generation: int, *, fsync: bool = True) -> None:
        data = (json.dumps({"format": HEAD_FORMAT,
                            "generation": int(generation)}) + "\n").encode()
        write_atomic(os.path.join(self.root, HEAD_NAME), data, fsync=fsync)

    def _read_head_hint(self) -> int | None:
        try:
            with open(os.path.join(self.root, HEAD_NAME)) as fh:
                d = json.load(fh)
            if isinstance(d, dict) and d.get("format") == HEAD_FORMAT:
                gen = d.get("generation")
                if isinstance(gen, int):
                    return gen
        except (OSError, json.JSONDecodeError):
            pass
        return None

    def _heal(self) -> None:
        """Repair the HEAD hint and the ``manifest.json`` mirror after a
        crash between the snapshot rename and the pointer updates. The
        snapshot chain itself is the source of truth, so healing only ever
        rewrites the two convenience files, atomically."""
        head = self.head_generation()
        if head < 1:
            return  # virgin or legacy-only: nothing catalog-owned to heal
        snap = self.load_snapshot(head)
        if self._read_head_hint() != head:
            self._write_head(head)
        try:
            mirror = DatasetManifest.load(self.root)
            stale = mirror.to_dict() != snap.manifest.to_dict()
        except DatasetError:
            stale = True  # missing or torn mirror
        if stale:
            snap.manifest.save(self.root)


def _mbr_of(cols) -> tuple[float, float, float, float]:
    """MBR over every coordinate; empty shards get the inverted no-hit box
    (same convention as the dataset writer)."""
    if cols.n_values == 0:
        return (float("inf"), float("inf"), float("-inf"), float("-inf"))
    return (float(cols.x.min()), float(cols.y.min()),
            float(cols.x.max()), float(cols.y.max()))


def zone_maps_from_footer(footer: dict) -> dict | None:
    """Shard-level zone maps: the footer's per-row-group ``extra_stats``
    merged across row groups (min of mins, max of maxes, summed counts).

    Returns None when the file carries no extra-column stats (no extras, or
    written before zone maps existed) — the shard then simply never gets
    predicate-pruned. Compacted shards get fresh merged maps for free
    because every staged shard passes through here.
    """
    merged: dict[str, dict] = {}
    seen = False
    for rg in footer.get("row_groups", ()):
        for k, st in rg.get("extra_stats", {}).items():
            seen = True
            z = merged.setdefault(
                k, {"min": None, "max": None, "nnan": 0, "count": 0})
            if st["min"] is not None:
                z["min"] = st["min"] if z["min"] is None else min(z["min"], st["min"])
                z["max"] = st["max"] if z["max"] is None else max(z["max"], st["max"])
            z["nnan"] += int(st["nnan"])
            z["count"] += int(st["count"])
    return merged if seen else None


class Compactor:
    """Merge small adjacent shards back into SFC order as new generations.

    The planner walks the manifest in order (manifest order == SFC key
    order) and greedily groups adjacent runs whose combined record count
    stays within ``target_records``; each run of two or more shards is
    rewritten as one merged shard file, unchanged shards carry over by
    reference. Because only *adjacent* runs merge, the concatenated record
    stream of the new generation is byte-for-byte the old one — full scans
    and refined bbox scans are bit-identical across compaction (unrefined
    bbox scans may differ only in which extra non-matching records page
    pruning lets through, as with any re-pagination).

    ``run_once`` pins the source generation while it reads, so a crash or a
    concurrent scan never observes half-merged state; the commit is the same
    atomic snapshot rename as any other. :meth:`start` runs it on a
    background thread every ``interval_s`` until :meth:`stop`. Merged
    shards are read and written on ``device`` (``"cuda"`` or ``"cpu"``).
    """

    def __init__(self, catalog: Catalog, *, target_records: int = 1 << 20,
                 page_values: int = 131072, row_group_records: int = 1 << 20,
                 interval_s: float = 0.25, device="cuda"):
        torch_device(device)
        self.catalog = catalog
        self.device = device
        self.target_records = int(target_records)
        self.page_values = int(page_values)
        self.row_group_records = int(row_group_records)
        self.interval_s = float(interval_s)
        self.compactions = 0
        self.errors = 0  # transient run_once failures survived by the loop
        self.last_error: BaseException | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ---------------------------------------------------------------- policy
    def plan(self, manifest: DatasetManifest) -> list[tuple[int, int]]:
        """Adjacent shard runs ``[lo, hi)`` (len >= 2) worth merging."""
        runs = []
        i, n = 0, manifest.n_shards
        while i < n:
            j = i
            total = 0
            while j < n and (j == i or
                             total + manifest.shards[j].n_records
                             <= self.target_records):
                total += manifest.shards[j].n_records
                j += 1
            if j - i >= 2:
                runs.append((i, j))
            i = max(j, i + 1)
        return runs

    # ------------------------------------------------------------------- run
    def run_once(self) -> Snapshot | None:
        """One compaction cycle; returns the committed snapshot, or None if
        there was nothing to merge (or the commit lost a generation race)."""
        t0 = time.perf_counter()
        with obs.span("catalog.compact"):
            pin = self.catalog.pin()
            try:
                runs = self.plan(pin.manifest)
                if not runs:
                    return None
                tx = self.catalog.begin()
                if tx.parent_gen != pin.generation:
                    return None  # head moved since we pinned; retry next tick
                try:
                    snap = self._compact_runs(pin.manifest, runs, tx)
                except CommitConflict:
                    tx.abort()
                    return None
                except Exception:
                    tx.abort()
                    raise
                except BaseException:
                    # simulated kill between staging calls: leave the files
                    # on disk for GC, but drop the in-memory in-flight
                    # registration a real kill would have lost
                    tx._forsake()
                    raise
            finally:
                pin.release()
        self.compactions += 1
        obs.count("catalog.compactions")
        obs.observe("catalog.compact_s", time.perf_counter() - t0)
        return snap

    def _compact_runs(self, manifest: DatasetManifest,
                      runs: list[tuple[int, int]], tx: CommitTx) -> Snapshot:
        merged: dict[int, ShardInfo] = {}
        covered: set[int] = set()
        for lo, hi in runs:
            cols_parts, extras_parts = [], []
            for i in range(lo, hi):
                geo, extras, _ = self._read_shard(manifest.shards[i])
                cols_parts.append(geo)
                extras_parts.append(extras)
            cols = concat_columns(cols_parts)
            extras = {
                k: np.concatenate([e[k] for e in extras_parts])
                for k in manifest.extra_schema
            }
            info = tx.stage_shard(
                cols, extras,
                encoding=manifest.encoding, codec=manifest.codec,
                page_values=self.page_values,
                row_group_records=self.row_group_records,
                extra_schema=dict(manifest.extra_schema), device=self.device)
            obs.instant("catalog.compact.merge", lo=lo, hi=hi,
                        records=cols.n_records)
            maybe_crash(CRASH_COMPACT_MID)
            merged[lo] = info
            covered.update(range(lo, hi))
        shards: list[ShardInfo] = []
        for i, s in enumerate(manifest.shards):
            if i in merged:
                shards.append(merged[i])
            elif i not in covered:
                shards.append(s)  # unchanged: carried over by reference
        new_manifest = DatasetManifest(
            coord_dtype=manifest.coord_dtype,
            codec=manifest.codec,
            encoding=manifest.encoding,
            sort=manifest.sort,
            extra_schema=dict(manifest.extra_schema),
            shards=shards,
        )
        return tx.commit(new_manifest)

    def _read_shard(self, info: ShardInfo):
        with SpatialParquetReader(
                shard_path(self.catalog.root, info)) as r:
            return r.read_columnar(device=self.device)

    # ------------------------------------------------------------ background
    def start(self) -> "Compactor":
        """Run :meth:`run_once` on a daemon thread every ``interval_s``.

        Ordinary exceptions (a transient ``OSError``, a shard read that
        loses a race with GC outside the retention window) are counted,
        reported through :mod:`repro_torch.obs`, and retried with exponential
        backoff — compaction must not silently die for the process lifetime
        on one bad tick. Only a simulated kill (:class:`InjectedCrash` /
        any other ``BaseException``) stops the loop, staying observable in
        ``last_error``.
        """
        if self._thread is not None:
            raise RuntimeError("compactor already started")
        self._stop.clear()

        def loop():
            consecutive = 0
            while not self._stop.is_set():
                try:
                    self.run_once()
                    consecutive = 0
                except Exception as exc:
                    self.errors += 1
                    consecutive += 1
                    self.last_error = exc
                    obs.count("catalog.compact_errors")
                    obs.instant("catalog.compact.error",
                                error=type(exc).__name__, detail=str(exc))
                    self._stop.wait(
                        self.interval_s * min(2 ** consecutive, 64))
                    continue
                except BaseException as exc:  # keep InjectedCrash observable
                    self.last_error = exc
                    break
                self._stop.wait(self.interval_s)

        self._thread = threading.Thread(target=loop, name="spqf-compactor",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float | None = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
