"""Fault-tolerant checkpointing with FP-delta compression
(``repro/train/checkpoint.py``), in the reference's on-disk format byte for
byte.

The paper's FP-delta codec (the host copy in :mod:`repro_torch.core.fp_delta`,
as the reference uses its host codec) losslessly compresses float32/int32
and float64/int64 leaves; bf16 and float8 leaves are compressed as their
raw bytes viewed as int32 words (still lossless).

Layout per checkpoint directory::

    step_000123/
      manifest.json    # leaf paths, shapes, dtypes, offsets, crc32s, codec
      data.bin         # concatenated (possibly compressed) leaf payloads
    latest             # text file: name of the newest complete checkpoint

Leaf keys are the dict keys on the path, sorted at every level and joined
by ``/`` (``jax.tree_util.tree_flatten_with_path``'s order), so each package
restores the other's checkpoints. bf16 and float8 leaves travel through
integer views of their bits under the dtype names ``"bfloat16"``,
``"float8_e4m3fn"`` and ``"float8_e5m2"``; every other dtype under numpy's
``dtype.str``. Writes are atomic (tmp dir + rename); ``keep`` bounds the
checkpoints kept. ``save`` snapshots every leaf to the host before it
returns, so a training step that then updates the tensors in place cannot
change what an asynchronous write puts on disk. Leaves are encoded by a
small thread pool and written in key order (the reference encodes them one
after another; the bytes are the same). A failed asynchronous write is
re-raised by the next ``wait`` or ``save`` (the reference's thread drops it).

On a mesh (DTensor leaves, every rank calling ``save``), each leaf is
gathered whole (``full_tensor``), rank 0 writes the same bytes a
one-device save writes, and every ``wait`` ends at a barrier of the default
group, so no rank reads a checkpoint before it is complete.
``restore_latest(mesh=..., placements=...)`` places the host leaves on any
mesh, whatever mesh saved them (the reference's elastic restore).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from .._device import torch_device
from ..core.fp_delta import fp_delta_decode, fp_delta_encode
from ..models.convert import flatten_with_paths, params_to, tree_map, unflatten
from ..sharding.dtensor import full, is_dtensor, shard_tensor

_ENCODE_WORKERS = min(8, os.cpu_count() or 1)

# dtypes numpy cannot name: stored as integer views of the same bits
_EXTENDED_DTYPES = {
    "bfloat16": (torch.bfloat16, np.dtype(np.int16)),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.dtype(np.uint8)),
    "float8_e5m2": (torch.float8_e5m2, np.dtype(np.uint8)),
}
_EXTENDED_NAMES = {t: name for name, (t, _) in _EXTENDED_DTYPES.items()}


@dataclass(frozen=True)
class HostLeaf:
    """A leaf snapshot on the host: its bits as a numpy array (an integer
    view for bf16 and float8) and its dtype name in the manifest."""

    array: np.ndarray
    dtype: str


def to_host(t: torch.Tensor) -> HostLeaf:
    """Copy a tensor's bits to a fresh host array."""
    t = t.detach()
    name = _EXTENDED_NAMES.get(t.dtype)
    if name is not None:
        t = t.view(torch.int16 if t.element_size() == 2 else torch.uint8)
    arr = t.to("cpu", copy=True).numpy()
    return HostLeaf(arr, name or arr.dtype.str)


def from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A CPU tensor of dtype ``dtype`` (a manifest name) over ``arr``'s bits."""
    t = torch.from_numpy(arr if arr.flags.c_contiguous else arr.copy())
    if dtype in _EXTENDED_DTYPES:
        t = t.view(_EXTENDED_DTYPES[dtype][0])
    return t


def _np_dtype(dtype: str) -> np.dtype:
    return _EXTENDED_DTYPES[dtype][1] if dtype in _EXTENDED_DTYPES else np.dtype(dtype)


def _encode_leaf(arr: np.ndarray, compress: bool) -> tuple[bytes, str]:
    if not compress or arr.size < 1024:
        return arr.tobytes(), "raw"
    if arr.dtype == np.float32 or arr.dtype == np.int32:
        payload, _ = fp_delta_encode(arr.reshape(-1))
        return payload, "fp_delta32"
    if arr.dtype == np.float64 or arr.dtype == np.int64:
        payload, _ = fp_delta_encode(arr.reshape(-1))
        return payload, "fp_delta64"
    # bf16 & friends: view raw bytes as int32 (pad) — still lossless fp-delta
    raw = arr.tobytes()
    pad = (-len(raw)) % 4
    as_i32 = np.frombuffer(raw + b"\x00" * pad, dtype=np.int32)
    payload, _ = fp_delta_encode(as_i32)
    return payload, f"fp_delta32_bytes:{len(raw)}"


def _decode_leaf(buf: bytes, codec: str, shape, dtype: str) -> np.ndarray:
    """The leaf's bits as a numpy array (an integer view for bf16/float8)."""
    dt = _np_dtype(dtype)
    n = int(np.prod(shape)) if shape else 1
    if codec == "raw":
        return np.frombuffer(buf, dtype=dt, count=n).reshape(shape).copy()
    if codec == "fp_delta32":
        flat = fp_delta_decode(buf, n, np.float32 if dt == np.float32 else np.int32)
        return flat.view(dt).reshape(shape).copy()
    if codec == "fp_delta64":
        flat = fp_delta_decode(buf, n, np.float64 if dt == np.float64 else np.int64)
        return flat.view(dt).reshape(shape).copy()
    if codec.startswith("fp_delta32_bytes:"):
        nbytes = int(codec.split(":")[1])
        n_i32 = (nbytes + 3) // 4
        flat = fp_delta_decode(buf, n_i32, np.int32)
        raw = flat.tobytes()[:nbytes]
        return np.frombuffer(raw, dtype=dt, count=n).reshape(shape).copy()
    raise ValueError(f"unknown codec {codec!r}")


@dataclass
class CheckpointStats:
    raw_bytes: int
    stored_bytes: int
    write_s: float = 0.0    # encode and write, up to the ``latest`` pointer

    @property
    def ratio(self) -> float:
        return self.raw_bytes / max(self.stored_bytes, 1)


class CheckpointManager:
    def __init__(self, directory, *, compress: bool = True, keep: int = 3,
                 async_save: bool = True):
        self.dir = str(directory)
        self.compress = compress
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(self.dir, exist_ok=True)
        self.last_stats: CheckpointStats | None = None
        self.history: list[CheckpointStats] = []   # one entry per completed write
        self._distributed = False   # set by the first save of DTensor leaves

    # ------------------------------------------------------------------ save
    def save(self, step: int, params, opt_state, metadata: dict | None = None,
             block: bool = False):
        """Snapshot every leaf to the host, then write (async by default).
        With DTensor leaves every rank calls this; rank 0 writes."""
        flat = flatten_with_paths({"params": params, "opt_state": opt_state})
        if any(is_dtensor(t) for _, t in flat):
            import torch.distributed as dist

            self._distributed = True
            leaves = [(k, full(t)) for k, t in flat]   # collectives: every rank
            if dist.get_rank() != 0:
                self.wait()
                return
            leaves = [(k, to_host(t)) for k, t in leaves]
        else:
            leaves = [(k, to_host(t)) for k, t in flat]
        self.wait()
        if self.async_save and not block:
            self._thread = threading.Thread(
                target=self._write_async, args=(step, leaves, metadata or {}), daemon=True)
            self._thread.start()
        else:
            self._write(step, leaves, metadata or {})

    def wait(self):
        """Join the pending asynchronous write; re-raise its error, if any.
        After a distributed save, every rank then meets at a barrier."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._distributed:
            import torch.distributed as dist

            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_async(self, *args):
        try:
            self._write(*args)
        except BaseException as e:  # noqa: BLE001 - re-raised by wait()
            self._error = e

    def _write(self, step: int, leaves: list[tuple[str, HostLeaf]], metadata: dict):
        t0 = time.perf_counter()
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, f".tmp_{name}")
        final = os.path.join(self.dir, name)
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "metadata": metadata, "leaves": []}
        raw_total = stored_total = 0
        # leaves encode on a pool (numpy releases the GIL in the codec's
        # passes) and are written in key order, so the bytes do not change
        with open(os.path.join(tmp, "data.bin"), "wb") as fh, \
                ThreadPoolExecutor(min(_ENCODE_WORKERS, len(leaves) or 1)) as pool:
            offset = 0
            encoded = pool.map(lambda kv: _encode_leaf(kv[1].array, self.compress), leaves)
            for (key, leaf), (payload, codec) in zip(leaves, encoded):
                arr = leaf.array
                fh.write(payload)
                manifest["leaves"].append({
                    "key": key,
                    "shape": list(arr.shape),
                    "dtype": leaf.dtype,
                    "offset": offset,
                    "nbytes": len(payload),
                    "codec": codec,
                    "crc32": zlib.crc32(payload) & 0xFFFFFFFF,
                })
                offset += len(payload)
                raw_total += arr.nbytes
                stored_total += len(payload)
        with open(os.path.join(tmp, "manifest.json"), "w") as fh:
            json.dump(manifest, fh)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(os.path.join(self.dir, "latest.tmp"), "w") as fh:
            fh.write(name)
        os.replace(os.path.join(self.dir, "latest.tmp"), os.path.join(self.dir, "latest"))
        self.last_stats = CheckpointStats(raw_total, stored_total, time.perf_counter() - t0)
        self.history.append(self.last_stats)
        self._gc()

    def _gc(self):
        ckpts = sorted(d for d in os.listdir(self.dir) if d.startswith("step_"))
        for d in ckpts[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        p = os.path.join(self.dir, "latest")
        if not os.path.exists(p):
            return None
        with open(p) as fh:
            name = fh.read().strip()
        if not os.path.exists(os.path.join(self.dir, name, "manifest.json")):
            return None
        return int(name.split("_")[1])

    def load_host(self, step: int | None = None):
        """Load a checkpoint fully on the host -> (step, tree of CPU tensors),
        or None if there is none."""
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        root = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(root, "manifest.json")) as fh:
            manifest = json.load(fh)
        with open(os.path.join(root, "data.bin"), "rb") as fh:
            data = fh.read()
        flat = {}
        for leaf in manifest["leaves"]:
            buf = data[leaf["offset"]: leaf["offset"] + leaf["nbytes"]]
            if (zlib.crc32(buf) & 0xFFFFFFFF) != leaf["crc32"]:
                raise IOError(f"checkpoint corruption at {leaf['key']} (crc mismatch)")
            arr = _decode_leaf(buf, leaf["codec"], tuple(leaf["shape"]), leaf["dtype"])
            flat[leaf["key"]] = from_host(arr, leaf["dtype"])
        return manifest["step"], unflatten(flat.items())

    def restore_latest(self, device="cuda", mesh=None, placements=None):
        """The newest checkpoint with every leaf on ``device`` ->
        (step, params, opt_state), or None if there is none. With a mesh,
        ``placements`` (``{"params": ..., "opt_state": ...}``, trees of
        DTensor placements) places each leaf on it."""
        dev = torch_device(device)
        loaded = self.load_host()
        if loaded is None:
            return None
        step, state = loaded
        params, opt_state = params_to(state["params"], dev), params_to(state["opt_state"], dev)
        if mesh is not None:
            put = lambda t, pl: shard_tensor(t, mesh, pl)   # noqa: E731
            params = tree_map(put, params, placements["params"])
            opt_state = tree_map(put, opt_state, placements["opt_state"])
        return step, params, opt_state
