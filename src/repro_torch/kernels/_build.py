"""Build and load the hand-written CUDA kernels (``repro_torch/csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with :mod:`ctypes`. Libraries go
into ``build/`` at the repository root, named by a hash of the source and
the flags, so an edited source rebuilds and an unchanged one loads as is.
Nothing is built at import time: the first launch of a kernel builds its
library, and :func:`build_all` builds several at once (one ``nvcc`` process
per source, all started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_entries: dict[tuple[str, str], object] = {}
logs: dict[str, str] = {}   # nvcc's output (ptxas registers, spills) of each source built here
_count_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; returns (process, tmp path, final path)
    or None when the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log.decode(errors='replace')}")
    logs[name] = log.decode(errors="replace")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build_all(names) -> None:
    """Build every named library that is missing, all ``nvcc`` runs at once."""
    with _lock:
        jobs = {n: _start(n) for n in names}
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
    return lib


def entry(name: str, fn_name: str, argtypes, restype=ctypes.c_int):
    """The C entry point ``fn_name`` of ``csrc/<name>.cu`` with its signature
    set, once: a wrapper called per page or per request pays a dict lookup."""
    fn = _entries.get((name, fn_name))
    if fn is None:
        fn = getattr(load(name), fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
        _entries[(name, fn_name)] = fn
    return fn


def check(lib: ctypes.CDLL, prefix: str, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        fn = getattr(lib, f"{prefix}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {err}: {fn(err).decode()}")


def bump(fn) -> None:
    """Add one to ``fn.launches``, the launch count of a kernel wrapper.

    Wrappers are called from worker threads (the dataset scanner reads
    shards in a thread pool), where ``fn.launches += 1`` could lose counts.
    """
    with _count_lock:
        fn.launches += 1
