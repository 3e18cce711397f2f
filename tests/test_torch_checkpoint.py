"""The port's checkpoints (``repro_torch.train.checkpoint``) against the JAX
package's, on the CPU: the same trees give the same ``manifest.json`` and
``data.bin`` bytes, each package restores the other's checkpoint bit for
bit, corruption is caught, ``keep`` is honoured and the asynchronous save
lands. Tolerance: exact bytes and exact bit patterns throughout.

Trees hold every kind of leaf the format distinguishes: float32 and int32
(``fp_delta32``), float64 and int64 (``fp_delta64``), bf16 and float8
(``fp_delta32_bytes:N``, an odd byte count among them), leaves under 1,024
values (``raw``) and the int32 ``step`` scalar, in nested dicts whose keys
are not in insertion order.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.train import checkpoint as jck  # noqa: E402
from repro_torch.models import flatten_with_paths  # noqa: E402
from repro_torch.train import checkpoint as tck  # noqa: E402


def _tree(rng):
    """The reference's numpy tree (ml_dtypes for bf16/float8)."""
    return {
        "params": {
            "w": rng.normal(0, 0.02, (64, 32)).astype(np.float32),
            "scale": np.ones(32, np.float32),
            "emb": rng.normal(0, 1, (100, 16)).astype(np.float32),
            "bf": rng.normal(0, 1, (33, 67)).astype(np.float32).astype(jnp.bfloat16),
            "f8": rng.normal(0, 1, (1031,)).astype(np.float32).astype(ml_dtypes.float8_e4m3fn),
            "f8b": rng.normal(0, 1, (40, 41)).astype(np.float32).astype(ml_dtypes.float8_e5m2),
            "d": rng.normal(0, 1, (2048,)),
            "ids": rng.integers(-5, 5, (4, 300)).astype(np.int64),
            "layers": {"wq": rng.normal(0, 1, (2, 24, 48)).astype(np.float32),
                       "ln": np.ones((2, 24), np.float32)},
        },
        "opt_state": {
            "m": {"w": np.zeros((64, 32), np.float32),
                  "cnt": rng.integers(0, 9, 5000).astype(np.int32)},
            "step": np.asarray(7, np.int32),
        },
    }


_TORCH = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
          "float8_e5m2": torch.float8_e5m2}


def _to_torch(tree):
    """The same tree as port tensors: bf16/float8 through their bits."""
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    a = np.array(tree)
    if a.dtype.name in _TORCH:
        carrier = np.int16 if a.dtype.itemsize == 2 else np.uint8
        return torch.from_numpy(a.view(carrier)).view(_TORCH[a.dtype.name])
    return torch.from_numpy(a)


def _flat(tree):
    """``{path: leaf}`` of a nested dict, in the port's one leaf order."""
    return dict(flatten_with_paths(tree))


def _bits(x) -> tuple[str, tuple, bytes]:
    """(dtype name, shape, raw bytes) of a numpy array or a tensor."""
    if torch.is_tensor(x):
        name = next((n for n, t in _TORCH.items() if t == x.dtype), None)
        carrier = x.view(torch.int16 if x.element_size() == 2 else torch.uint8) if name else x
        arr = carrier.numpy()
        return name or arr.dtype.str, tuple(arr.shape), arr.tobytes()
    a = np.asarray(x)
    return (a.dtype.name if a.dtype.name in _TORCH else a.dtype.str), a.shape, a.tobytes()


def _same_bits(a, b):
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert _bits(fa[k]) == _bits(fb[k]), k


def _files(root, step):
    d = os.path.join(root, f"step_{step:08d}")
    return {n: open(os.path.join(d, n), "rb").read() for n in ("manifest.json", "data.bin")}


@pytest.mark.parametrize("compress", [True, False])
def test_bytes_equal_reference(tmp_path, rng, compress):
    t = _tree(rng)
    jm = jck.CheckpointManager(tmp_path / "jax", compress=compress, async_save=False)
    tm = tck.CheckpointManager(tmp_path / "port", compress=compress, async_save=False)
    meta = {"arch": "spatial-lm", "seq": 256}
    jm.save(12, t["params"], t["opt_state"], metadata=meta)
    tt = _to_torch(t)
    tm.save(12, tt["params"], tt["opt_state"], metadata=meta)
    assert _files(tmp_path / "port", 12) == _files(tmp_path / "jax", 12)
    assert open(tmp_path / "port" / "latest").read() == open(tmp_path / "jax" / "latest").read()
    assert (tm.last_stats.raw_bytes, tm.last_stats.stored_bytes) == \
        (jm.last_stats.raw_bytes, jm.last_stats.stored_bytes)
    if compress:
        codecs = {leaf["codec"].split(":")[0] for leaf in
                  __import__("json").loads(_files(tmp_path / "port", 12)["manifest.json"])["leaves"]}
        assert codecs == {"raw", "fp_delta32", "fp_delta64", "fp_delta32_bytes"}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_restores_the_other(tmp_path, rng, writer):
    t = _tree(rng)
    tt = _to_torch(t)
    if writer == "jax":
        jck.CheckpointManager(tmp_path, async_save=False).save(3, t["params"], t["opt_state"])
    else:
        tck.CheckpointManager(tmp_path, async_save=False).save(3, tt["params"], tt["opt_state"])
    step, host = tck.CheckpointManager(tmp_path).load_host()
    assert step == 3
    _same_bits(host, tt)
    step, params, opt = tck.CheckpointManager(tmp_path).restore_latest(device="cpu")
    assert step == 3
    _same_bits({"params": params, "opt_state": opt}, tt)
    step, jhost = jck.CheckpointManager(tmp_path).load_host()
    assert step == 3
    _same_bits(jhost, t)


def test_corruption_detected(tmp_path, rng):
    mgr = tck.CheckpointManager(tmp_path, async_save=False)
    t = _to_torch(_tree(rng))
    mgr.save(1, t["params"], t["opt_state"])
    data = os.path.join(tmp_path, f"step_{1:08d}", "data.bin")
    blob = bytearray(open(data, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(data, "wb").write(bytes(blob))
    with pytest.raises(IOError, match="crc"):
        mgr.load_host()


def test_gc_keeps_last_k(tmp_path, rng):
    mgr = tck.CheckpointManager(tmp_path, keep=2, async_save=False)
    t = _to_torch(_tree(rng))
    for s in (1, 2, 3, 4):
        mgr.save(s, t["params"], t["opt_state"])
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_00000003", "step_00000004"]
    assert mgr.latest_step() == 4
    # every write is recorded, with its own seconds
    assert len(mgr.history) == 4 and mgr.history[-1] is mgr.last_stats
    assert all(st.write_s > 0 and st.stored_bytes > 0 for st in mgr.history)


def test_async_save_snapshots_before_returning(tmp_path, rng):
    """The write runs on a thread; what it writes is the tree at ``save``,
    even if the caller updates the tensors in place right after."""
    mgr = tck.CheckpointManager(tmp_path, async_save=True)
    t = _to_torch(_tree(rng))
    want = {k: v.clone() for k, v in _flat(t).items()}
    mgr.save(5, t["params"], t["opt_state"])
    t["params"]["w"].add_(1.0)
    t["opt_state"]["step"].add_(1)
    mgr.wait()
    assert mgr.latest_step() == 5
    _, host = mgr.load_host()
    got = _flat(host)
    for k in want:
        assert _bits(got[k]) == _bits(want[k]), k


def test_restore_without_checkpoint_and_device_rule(tmp_path):
    mgr = tck.CheckpointManager(tmp_path)
    assert mgr.restore_latest(device="cpu") is None and mgr.load_host() is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mgr.restore_latest()


def test_async_write_error_surfaces(tmp_path, rng, monkeypatch):
    """A write that fails on the background thread raises at ``wait``, and
    leaves no checkpoint behind."""
    def boom(arr, compress):
        raise OSError("disk full")

    mgr = tck.CheckpointManager(tmp_path, async_save=True)
    t = _to_torch(_tree(rng))
    monkeypatch.setattr(tck, "_encode_leaf", boom)
    mgr.save(2, t["params"], t["opt_state"])
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.latest_step() is None
    mgr.wait()                                  # the error is reported once
