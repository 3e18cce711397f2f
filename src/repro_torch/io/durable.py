"""Durable-write helpers: the fsync + temp-file + rename discipline.

Every catalog mutation (snapshot files, HEAD pointers, manifest mirrors)
goes through :func:`write_atomic`: bytes land in a same-directory temp file,
are fsynced, and reach their final name through ``os.replace`` — so any
observer (including a post-crash reopen) sees either the complete old file
or the complete new file, never a torn write. :func:`fsync_dir` makes the
rename itself durable on POSIX (the directory entry is metadata of the
*directory*, not the file).

Temp files embed the ``.tmp-`` marker (:data:`TMP_MARKER`) so an
interrupted writer's leftovers are recognizable as orphans by the catalog
GC instead of being mistaken for user data.
"""

from __future__ import annotations

import os
import tempfile

TMP_MARKER = ".tmp-"


def fsync_file(fh) -> None:
    """Flush and fsync an open file object."""
    fh.flush()
    os.fsync(fh.fileno())


def fsync_path(path) -> None:
    """fsync an already-written file by path (reopen read-only)."""
    fd = os.open(str(path), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path) -> None:
    """fsync a directory so renames/creates inside it are durable.

    Silently a no-op where directories cannot be opened/fsynced (e.g.
    Windows): the rename is still atomic there, only the durability of the
    directory entry is weaker.
    """
    try:
        fd = os.open(str(path), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def tmp_name_for(path) -> tuple[int, str]:
    """A same-directory temp file for ``path`` (mkstemp fd + name).

    The name embeds :data:`TMP_MARKER` so catalog GC can identify leftovers
    from interrupted writes.
    """
    d, base = os.path.split(str(path))
    return tempfile.mkstemp(dir=d or ".", prefix=f".{base}{TMP_MARKER}")


def is_tmp_name(name: str) -> bool:
    """Does ``name`` look like one of our interrupted-write temp files?"""
    base = os.path.basename(str(name))
    return base.startswith(".") and TMP_MARKER in base


def write_atomic(path, data: bytes, *, fsync: bool = True) -> str:
    """Write ``data`` to ``path`` atomically (temp + fsync + ``os.replace``).

    On an ordinary exception the temp file is removed; on a simulated crash
    (:class:`~repro_torch.io.faults.InjectedCrash`, a ``BaseException``) it is
    deliberately left behind, exactly like a real kill would — catalog GC
    owns the cleanup.
    """
    path = str(path)
    fd, tmp = tmp_name_for(path)
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(data)
            if fsync:
                fsync_file(fh)
        os.replace(tmp, path)
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if fsync:
        fsync_dir(os.path.dirname(path) or ".")
    return path
