"""Build and load the hand-written CUDA kernels (``repro_torch/csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with :mod:`ctypes`. Libraries go
into ``build/`` at the repository root, named by a hash of the source and
the flags, so an edited source rebuilds and an unchanged one loads as is.
Nothing is built at import time: the first launch of a kernel builds its
library, and :func:`build_all` builds several at once (one ``nvcc`` process
per source, all started together).

Builds are observable as the reference's ``jit`` compiles are
(``repro/kernels/fp_delta/ops.py::_aot``): while tracing is on, each
``nvcc`` run is a ``kernel.build`` span (cat ``build``) and counts
``kernel.builds``; opening a library already in ``build/`` counts
``kernel.loads``; an :func:`entry` lookup served from the cache counts
``kernel.cache_hits`` (one a launch, two for the page-stream decode, which
also asks for its scratch size). :func:`compile_cache_stats` lists what is
loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from repro_torch import obs

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
    """Start ``nvcc`` for one source; returns (process, tmp path, final path)."""
    out = _lib_path(name)
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


def _build_one(name: str) -> None:
    """Run ``nvcc`` for one source inside a ``kernel.build`` span."""
    with obs.span("kernel.build", cat="build", source=name):
        obs.count("kernel.builds")
        _finish(name, _start(name))


def build_all(names) -> list[str]:
    """Build every named library that is missing, all ``nvcc`` runs at once
    (a thread waits on each); returns the names it built."""
    with _lock:
        missing = [n for n in dict.fromkeys(names) if not _lib_path(n).exists()]
        if missing:
            with ThreadPoolExecutor(len(missing)) as pool:
                for f in [obs.submit(pool, _build_one, n) for n in missing]:
                    f.result()
    return missing


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    built = build_all([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
            if not built:
                obs.count("kernel.loads")
    return lib


def entry(name: str, fn_name: str, argtypes, restype=ctypes.c_int):
    """The C entry point ``fn_name`` of ``csrc/<name>.cu`` with its signature
    set, once: a wrapper called per page or per request pays a dict lookup."""
    fn = _entries.get((name, fn_name))
    if fn is not None:
        obs.count("kernel.cache_hits")
        return fn
    fn = getattr(load(name), fn_name)
    fn.argtypes = argtypes
    fn.restype = restype
    _entries[(name, fn_name)] = fn
    return fn


def compile_cache_stats() -> dict:
    """What is loaded: each library (``<name>``) and each entry point set
    up (``<name>:<function>``), the counterpart of the reference's
    compiled-bucket listing."""
    keys = sorted(list(_libs) + [f"{n}:{f}" for n, f in _entries])
    return {"count": len(keys), "keys": keys}


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
