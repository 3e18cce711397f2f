"""The port's tokenizer and training data feed held against the JAX package's.

The reference's ten cases (``tests/test_data_pipeline.py``), each run
through both packages: the same coordinates through both tokenizers, the
same generators, and batchers over files and datasets that each package
wrote itself from one seed (the files are byte-identical, held by
``tests/test_torch_read_path.py`` and ``tests/test_torch_dataset.py``). The
reference batches on ``"cpu"`` (numpy) and, where named, ``"jax"`` (Pallas
in interpret mode); the port on ``"host"`` (numpy) and ``"cpu"`` (the
kernels' plain versions on CPU tensors). Batches must be equal bit for bit.
"""

import os
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import repro.data.pipeline as jpipe  # noqa: E402
import repro.data.synthetic as jsynth  # noqa: E402
import repro.data.tokenizer as jtok  # noqa: E402
import repro.dataset as jds  # noqa: E402
from repro.core.pages import best_codec as j_best_codec  # noqa: E402
from repro.core.writer import write_file as j_write  # noqa: E402
import repro_torch.data.pipeline as tpipe  # noqa: E402
import repro_torch.data.synthetic as tsynth  # noqa: E402
import repro_torch.data.tokenizer as ttok  # noqa: E402
import repro_torch.dataset as tds  # noqa: E402
from repro_torch.core.pages import best_codec as t_best_codec  # noqa: E402
from repro_torch.core.writer import write_file as t_write  # noqa: E402

BBOX = tsynth.PORTO_BBOX
PORT_DEVICES = ("host", "cpu")


def _files(tmp_path, name, n_traj, seed, **kw):
    """One file per package from the same generator seed."""
    jp, tp = tmp_path / f"ref-{name}.spqf", tmp_path / f"port-{name}.spqf"
    j_write(jp, columns=jsynth.porto_taxi_like(n_traj=n_traj, seed=seed), **kw)
    t_write(tp, columns=tsynth.porto_taxi_like(n_traj=n_traj, seed=seed), device="cpu", **kw)
    assert jp.read_bytes() == tp.read_bytes()
    return str(jp), str(tp)


def _lakes(tmp_path, name, n_traj, seed, **kw):
    jr, tr = tmp_path / f"ref-{name}", tmp_path / f"port-{name}"
    jds.write_dataset(jr, columns=jsynth.porto_taxi_like(n_traj=n_traj, seed=seed), **kw)
    tds.write_dataset(tr, columns=tsynth.porto_taxi_like(n_traj=n_traj, seed=seed),
                      device="cpu", **kw)
    return jr, tr


def _batches(batcher):
    return [b["tokens"] for b in batcher]


def _assert_batches_equal(got, want, ctx):
    assert len(got) == len(want) > 0, ctx
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32 and g.shape == w.shape, ctx
        assert np.array_equal(g, w), ctx


def _both_batchers(jsrc, tsrc, *, ref_devices=("cpu",), **kw):
    """The reference's batches on each of its devices, and the port's on
    each of its own, all from the same settings; every list equal."""
    want = _batches(jpipe.TrajectoryBatcher(jsrc, jtok.GeoTokenizer(BBOX, order=6),
                                            device=ref_devices[0], **kw))
    for d in ref_devices[1:]:
        _assert_batches_equal(_batches(jpipe.TrajectoryBatcher(
            jsrc, jtok.GeoTokenizer(BBOX, order=6), device=d, **kw)), want, d)
    for d in PORT_DEVICES:
        _assert_batches_equal(_batches(tpipe.TrajectoryBatcher(
            tsrc, ttok.GeoTokenizer(BBOX, order=6), device=d, **kw)), want, d)
    return want


def test_tokenizer_cell_roundtrip(rng):
    tok, jt = ttok.GeoTokenizer(BBOX, order=6), jtok.GeoTokenizer(BBOX, order=6)
    x = rng.uniform(BBOX[0], BBOX[2], 1000)
    y = rng.uniform(BBOX[1], BBOX[3], 1000)
    t = tok.encode_points(x, y)
    assert np.array_equal(t, jt.encode_points(x, y)) and tok.vocab == jt.vocab
    assert t.min() >= 3 and t.max() < tok.vocab
    xy = tok.decode_tokens(t)
    assert np.array_equal(xy, jt.decode_tokens(t))
    cell_w = (BBOX[2] - BBOX[0]) / 2**6
    cell_h = (BBOX[3] - BBOX[1]) / 2**6
    assert np.all(np.abs(xy[:, 0] - x) <= cell_w)
    assert np.all(np.abs(xy[:, 1] - y) <= cell_h)


def test_tokenizer_locality(rng):
    tok = ttok.GeoTokenizer(BBOX, order=6)
    x = rng.uniform(BBOX[0], BBOX[2], 2000)
    y = rng.uniform(BBOX[1], BBOX[3], 2000)
    t0 = tok.encode_points(x, y)
    t_near = tok.encode_points(x + 1e-5, y + 1e-5)
    assert np.array_equal(t_near, jtok.GeoTokenizer(BBOX, order=6).encode_points(
        x + 1e-5, y + 1e-5))
    assert (t0 == t_near).mean() > 0.9
    assert (ttok.PAD, ttok.BOS, ttok.EOS, ttok.N_SPECIAL) == (
        jtok.PAD, jtok.BOS, jtok.EOS, jtok.N_SPECIAL)


@pytest.mark.parametrize("gen,n,t", [("porto_taxi_like", 50, 4), ("roads_like", 50, 5),
                                     ("buildings_like", 50, 3), ("ebird_like", 500, 1)])
def test_synthetic_generators_shapes(gen, n, t):
    cols, jcols = getattr(tsynth, gen)(n), getattr(jsynth, gen)(n)
    assert cols.n_records >= 50 or t == 1
    assert (cols.types == t).all()
    assert np.isfinite(cols.x).all() and np.isfinite(cols.y).all()
    for f in ("types", "type_rep", "rep", "defn", "x", "y"):
        assert np.array_equal(getattr(cols, f), getattr(jcols, f)), f


def test_trajectory_batcher_end_to_end(tmp_path):
    jp, tp = _files(tmp_path, "a", 300, 1, sort="hilbert", codec=t_best_codec())
    assert j_best_codec() == t_best_codec()
    want = _both_batchers([jp], [tp], ref_devices=("cpu", "jax"), seq_len=96,
                          global_batch=8, accum=2, loop=False)
    batch = want[0]
    assert batch.shape == (2, 4, 96)
    flat = batch.reshape(-1, 96)
    assert (flat[:, 0] == ttok.BOS).all()
    assert ((flat == ttok.EOS).sum(axis=1) >= 1).all()
    assert flat.max() < ttok.GeoTokenizer(BBOX, order=6).vocab


def test_batcher_bbox_pushdown(tmp_path):
    jp, tp = _files(tmp_path, "b", 400, 2, sort="hilbert", page_values=2048)
    half = (BBOX[0], BBOX[1], (BBOX[0] + BBOX[2]) / 2, (BBOX[1] + BBOX[3]) / 2)
    want = _both_batchers([jp], [tp], ref_devices=("cpu", "jax"), seq_len=64,
                          global_batch=4, bbox=half, loop=False)
    tok = ttok.GeoTokenizer(BBOX, order=6)
    toks = want[0].reshape(-1)
    toks = toks[toks >= 3]
    xy = tok.decode_tokens(toks)
    cell_w = (BBOX[2] - BBOX[0]) / 2**6
    assert xy[:, 0].max() <= half[2] + 0.02 + cell_w


def test_prefetcher_propagates_worker_exception_promptly():
    def boom():
        raise ValueError("bad shard")
        yield  # pragma: no cover - makes this a generator

    pf = tpipe.Prefetcher(boom(), depth=2, stall_timeout=30.0)
    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="bad shard"):
        next(pf)
    assert time.perf_counter() - t0 < 5.0
    with pytest.raises(ValueError, match="bad shard"):
        next(pf)
    assert pf.stalls == 0


def test_prefetcher_delivers_buffered_items_then_error():
    def two_then_boom():
        yield 1
        yield 2
        raise RuntimeError("producer died")

    pf = tpipe.Prefetcher(two_then_boom(), depth=4, stall_timeout=30.0)
    assert next(pf) == 1
    assert next(pf) == 2
    with pytest.raises(RuntimeError, match="producer died"):
        next(pf)


def test_prefetcher_exhaustion_is_sticky():
    pf = tpipe.Prefetcher(iter([1, 2]), depth=4, stall_timeout=30.0)
    assert list(pf) == [1, 2]
    t0 = time.perf_counter()
    with pytest.raises(StopIteration):
        next(pf)
    assert time.perf_counter() - t0 < 5.0
    assert pf.stalls == 0


@pytest.mark.parametrize("device", PORT_DEVICES)
def test_batcher_rejects_empty_sources(tmp_path, device):
    _, root = _lakes(tmp_path, "lake", 50, 9, n_shards=2, sort="hilbert")
    tok = ttok.GeoTokenizer(BBOX, order=6)
    with pytest.raises(ValueError, match="bbox pruned"):
        tpipe.TrajectoryBatcher([root], tok, seq_len=64, global_batch=4,
                                bbox=(50.0, 50.0, 51.0, 51.0), device=device)
    with pytest.raises(ValueError, match="no input"):
        tpipe.TrajectoryBatcher([], tok, seq_len=64, global_batch=4, device=device)
    with pytest.raises(ValueError, match="device must be"):
        tpipe.TrajectoryBatcher([root], tok, seq_len=64, global_batch=4, device="jax")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpipe.TrajectoryBatcher([root], tok, seq_len=64, global_batch=4)


def test_batcher_stripes_over_dataset_shards(tmp_path):
    jroot, root = _lakes(tmp_path, "lake", 300, 5, n_shards=4, sort="hilbert",
                         page_values=2048)
    assert len(tpipe.expand_sources([root])) == 4
    jsingle, single = _files(tmp_path, "one", 300, 5, sort="hilbert")
    assert tpipe.expand_sources([single]) == [single]
    corner = (BBOX[0], BBOX[1], BBOX[0] + 0.05, BBOX[1] + 0.04)
    shards = [os.path.basename(p) for p in tpipe.expand_sources([root], corner)]
    assert shards == [os.path.basename(p) for p in jpipe.expand_sources([jroot], corner)]
    assert 0 < len(shards) < 4
    want = _both_batchers([jroot], [root], seq_len=64, global_batch=4, bbox=corner,
                          loop=False)
    assert want[0].shape == (1, 4, 64)
    # full extent over shards and a file, through the prefetcher
    b2 = tpipe.TrajectoryBatcher([root, single], ttok.GeoTokenizer(BBOX, order=6),
                                 seq_len=64, global_batch=4, device="cpu")
    assert len(b2.files) == 5
    jb2 = jpipe.TrajectoryBatcher([jroot, jsingle], jtok.GeoTokenizer(BBOX, order=6),
                                  seq_len=64, global_batch=4)
    _assert_batches_equal([next(tpipe.Prefetcher(b2, depth=2))["tokens"]],
                          [next(jpipe.Prefetcher(jb2, depth=2))["tokens"]], "prefetch")


@pytest.mark.parametrize("arch,accum", [("qwen3-8b", 1), ("whisper-medium", 2),
                                        ("pixtral-12b", 2)])
def test_synthetic_token_iter_matches_reference(arch, accum):
    """Dense, encoder-decoder and vision-language batches: same keys,
    dtypes, shapes and bits as the reference's from the same seed."""
    from repro.configs import get_config as j_config
    from repro_torch.configs import get_config as t_config

    jcfg, tcfg = j_config(arch).reduced(), t_config(arch).reduced()
    kw = dict(seq_len=64, global_batch=4, accum=accum, seed=5, family=tcfg.family)
    want = jpipe.synthetic_token_iter(jcfg.vocab, cfg=jcfg, **kw)
    got = tpipe.synthetic_token_iter(tcfg.vocab, cfg=tcfg, **kw)
    keys = {"dense": {"tokens"}, "encdec": {"tokens", "frames"},
            "vlm": {"tokens", "patches"}}[tcfg.family]
    for _ in range(3):
        w, g = next(want), next(got)
        assert set(g) == set(w) == keys
        for k in keys:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            assert np.array_equal(g[k], w[k]), k
    assert g["tokens"].shape[:2] == (accum, 4 // accum)
