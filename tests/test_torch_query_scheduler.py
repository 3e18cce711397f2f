"""The port's multi-query bbox server held against the JAX package's.

Both packages write the same lake (``porto_taxi_like(n_traj=300, seed=11)``,
3 Hilbert shards, ``page_values=2048``; the shard files are byte-identical,
held by ``tests/test_torch_dataset.py``) and their servers take the same
submissions: overlapping grid cells, the full extent, an empty box, no box,
a NaN-bound box, and a ``Range`` filter. The reference serves on ``"cpu"``
(numpy) and ``"jax"`` (Pallas kernels in interpret mode), the port on
``"host"`` (numpy) and ``"cpu"`` (the kernels' plain versions on CPU
tensors). Compared: every query's geometry (coordinate bit patterns and
levels), extras, ``ReadStats`` and the server's counters (latencies
excepted). Tolerance: exact.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import repro.data.synthetic as jsynth  # noqa: E402
import repro.dataset as jds  # noqa: E402
import repro.kernels.fp_delta.ops as jops  # noqa: E402
import repro.kernels.minmax as jmm  # noqa: E402
from repro.core.filters import Range as JRange  # noqa: E402
from repro.serve.query_scheduler import SpatialQueryServer as JServer  # noqa: E402
import repro_torch.data.synthetic as tsynth  # noqa: E402
import repro_torch.dataset as tds  # noqa: E402
import repro_torch.kernels.fp_delta.ops as tops  # noqa: E402
import repro_torch.kernels.minmax as tmm  # noqa: E402
from repro_torch.core.filters import Range as TRange  # noqa: E402
from repro_torch.kernels.fp_delta import (  # noqa: E402
    decode_refine_stream,
    decode_refine_stream_multi,
    refine_minmax_multi,
)
from repro_torch.serve import SpatialQueryServer as TServer  # noqa: E402

BBOX = jsynth.PORTO_BBOX
STAT_FIELDS = ("pages_total", "pages_read", "bytes_total", "bytes_read",
               "records_scanned", "records_returned", "shards_total",
               "shards_read")
COUNTERS = ("queries", "waves", "rg_touches", "rg_decodes", "shared_decode_ratio",
            "cache_hits", "cache_misses", "cache_evictions", "cache_entries")
WRITE_KW = dict(n_shards=3, sort="hilbert", page_values=2048)
PORT_DEVICES = ("host", "cpu")
REF_DEVICES = ("cpu", "jax")


def _write(synth, ds, root, dev, n_traj=300, seed=11, n_shards=3, int_coords=False):
    cols = synth.porto_taxi_like(n_traj=n_traj, seed=seed)
    if int_coords:
        cols = dataclasses.replace(cols, x=np.round(cols.x * 1e5).astype(np.int64),
                                   y=np.round(cols.y * 1e5).astype(np.int64))
    extra = {"tid": np.arange(cols.n_records, dtype=np.int64)}
    ds.write_dataset(root, columns=cols, extra=extra,
                     **{**WRITE_KW, "n_shards": n_shards, **dev})
    return root


@pytest.fixture(scope="module")
def lakes(tmp_path_factory):
    base = tmp_path_factory.mktemp("serve_lakes")
    return (_write(jsynth, jds, base / "ref", {}),
            _write(tsynth, tds, base / "port", {"device": "cpu"}))


def _boxes():
    """Overlapping grid cells + full extent, empty, None and NaN queries."""
    x0, y0, x1, y1 = BBOX
    xs = np.linspace(x0, x1, 4)
    ys = np.linspace(y0, y1, 4)
    boxes = [(xs[i], ys[j], xs[i + 1], ys[j + 1])
             for i in range(3) for j in range(3)]
    boxes.append(BBOX)                       # full extent
    boxes.append((50.0, 50.0, 51.0, 51.0))   # empty: far from Porto
    boxes.append(None)                       # no filter
    boxes.append((np.nan, y0, x1, y1))       # NaN bound: keeps nothing
    return boxes


def _submissions():
    """(bbox, columns, filter factory) per query: every box, a Range filter
    with and without a box, and a geometry-only projection."""
    subs = [(b, None, None) for b in _boxes()]
    subs.append((BBOX, None, lambda R: R("tid", 50, 4000)))
    subs.append((None, None, lambda R: R("tid", 100, 900)))
    subs.append((BBOX, ("geometry",), None))
    return subs


def _submit(srv, R, subs):
    return [srv.submit(b, columns=c, filter=f(R) if f else None) for b, c, f in subs]


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({8: np.int64, 4: np.int32, 2: np.int16, 1: np.int8}[a.dtype.itemsize])


def _assert_query_equal(a, b, ctx, stats=True):
    if a.geo is None or b.geo is None:
        assert a.geo is None and b.geo is None, ctx
    else:
        for f in ("types", "type_rep", "rep", "defn", "x", "y"):
            assert np.array_equal(_bits(getattr(a.geo, f)), _bits(getattr(b.geo, f))), (ctx, f)
    assert set(a.extras) == set(b.extras), ctx
    for k in a.extras:
        assert np.array_equal(_bits(a.extras[k]), _bits(b.extras[k])), (ctx, k)
    for f in STAT_FIELDS if stats else ():
        assert getattr(a.stats, f) == getattr(b.stats, f), (ctx, f)
    assert a.done and b.done and a.latency_s >= 0.0 and b.latency_s >= 0.0


def _counters(srv):
    m = srv.metrics()
    return {k: m[k] for k in COUNTERS}


def _serve(Server, R, root, scanner_mod, device, subs, **kw):
    with Server(scanner_mod.SpatialDatasetScanner(root), device=device, **kw) as srv:
        qs = _submit(srv, R, subs)
        done = srv.run()
        assert done == qs
        return qs, _counters(srv)


@pytest.fixture(scope="module")
def reference_waves(lakes):
    """The reference server's answers on both of its devices, computed once."""
    return {d: _serve(JServer, JRange, lakes[0], jds, d, _submissions(),
                      cache_rgs=64, max_wave=8) for d in REF_DEVICES}


@pytest.mark.parametrize("device", PORT_DEVICES)
def test_server_matches_reference(lakes, reference_waves, device):
    """13 boxes + 3 more over max_wave=8: several waves, shared decodes,
    cache hits across waves; every query equal to both reference devices'
    and to the port's own solo scan."""
    qs, counters = _serve(TServer, TRange, lakes[1], tds, device, _submissions(),
                          cache_rgs=64, max_wave=8)
    assert counters["waves"] >= 2
    scanner = tds.SpatialDatasetScanner(lakes[1])
    for ref_dev, (jqs, jcounters) in reference_waves.items():
        assert counters == jcounters, (device, ref_dev)
        for q, jq in zip(qs, jqs):
            _assert_query_equal(q, jq, (device, ref_dev, q.bbox))
    for q, (b, c, f) in zip(qs, _submissions()):
        geo, extras, st = scanner.scan(b, columns=c, filter=f(TRange) if f else None,
                                       refine=True, device=device, parallel=False)
        solo = type(q)(q.qid, b, geo=geo, extras=extras, stats=st, done=True)
        _assert_query_equal(q, solo, ("solo", device, b))


SCENARIOS = {
    # every wave evicts: the LRU holds one row group
    "evict": dict(kw=dict(cache_rgs=1, max_wave=4), waves=[_boxes()[:10]]),
    # a second wave over the same boxes decodes nothing
    "pure_hit": dict(kw=dict(cache_rgs=64, max_wave=64), waves=[[BBOX] * 16, [BBOX] * 16]),
    # invalidate() drops the cache: the next wave decodes again
    "invalidate": dict(kw=dict(cache_rgs=64), waves=[[BBOX], [BBOX], "invalidate", [BBOX]]),
}


def _run_scenario(Server, scanner_mod, root, device, sc):
    qs, snaps = [], []
    with Server(scanner_mod.SpatialDatasetScanner(root), device=device, **sc["kw"]) as srv:
        for wave in sc["waves"]:
            if wave == "invalidate":
                srv.invalidate()
                assert len(srv.cache) == 0
                continue
            qs += [srv.submit(b) for b in wave]
            srv.run()
            snaps.append(_counters(srv))
    return qs, snaps


@pytest.mark.parametrize("device", PORT_DEVICES)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_cache_scenarios_match_reference(lakes, device, name):
    sc = SCENARIOS[name]
    jqs, jsnaps = _run_scenario(JServer, jds, lakes[0], "cpu", sc)
    qs, snaps = _run_scenario(TServer, tds, lakes[1], device, sc)
    assert snaps == jsnaps
    for q, jq in zip(qs, jqs):
        _assert_query_equal(q, jq, (name, device, q.bbox))
    if name == "evict":
        assert snaps[-1]["cache_evictions"] > 0 and snaps[-1]["cache_entries"] <= 1
    if name == "pure_hit":
        assert snaps[1]["rg_decodes"] == snaps[0]["rg_decodes"] > 0
        assert snaps[0]["shared_decode_ratio"] == pytest.approx(16)
    if name == "invalidate":
        d = [s["rg_decodes"] for s in snaps]
        assert d[0] == d[1] > 0 and d[2] == 2 * d[0]


@pytest.mark.parametrize("device", PORT_DEVICES)
def test_catalog_commit_redecodes_like_reference(tmp_path, device):
    """A compaction commit between waves bumps the server's generation in
    both packages: readers reopen, the cache redecodes, results hold."""
    out = {}
    for side, synth, ds, R, Server, dev, sdev in (
            ("ref", jsynth, jds, JRange, JServer, {}, "cpu"),
            ("port", tsynth, tds, TRange, TServer, {"device": "cpu"}, device)):
        root = _write(synth, ds, tmp_path / side, dev, n_traj=240, seed=13, n_shards=6)
        with Server(ds.SpatialDatasetScanner(root), device=sdev, cache_rgs=64) as srv:
            assert srv.data_generation == 1
            q0 = srv.submit(BBOX)
            srv.run()
            snaps = [_counters(srv)]
            gen_key = srv.generation
            comp = ds.Compactor(ds.Catalog.open(root), target_records=1 << 30,
                                page_values=2048, **dev)
            assert comp.run_once().generation == 2
            q1 = srv.submit(BBOX)
            srv.run()
            assert srv.data_generation == 2 and srv.generation == gen_key + 1
            snaps.append(_counters(srv))
            q2 = srv.submit(BBOX)
            srv.run()
            snaps.append(_counters(srv))
            assert snaps[1]["rg_decodes"] > snaps[0]["rg_decodes"]
            assert snaps[2]["rg_decodes"] == snaps[1]["rg_decodes"]
            # the layout changed (one shard): same records, other stats
            _assert_query_equal(q1, q0, (side, "post-compaction"), stats=False)
            _assert_query_equal(q2, q1, (side, "steady"))
        out[side] = (snaps, [q0, q1, q2])
    assert out["port"][0] == out["ref"][0]
    for q, jq in zip(out["port"][1], out["ref"][1]):
        _assert_query_equal(q, jq, ("commit", device))


def test_mixed_host_and_device_chunks_match_reference(lakes, monkeypatch):
    """With the launch cap lowered (in both packages), each row group splits
    into several device chunks and host chunks for the largest page pairs:
    both branches of the keep and gather run in one row group."""
    tscan = tds.SpatialDatasetScanner(lakes[1])

    def kinds(s):
        with tscan.open_shard(s) as r:
            return [c.kind for c in r.read_row_group(0, device="cpu").chunks]

    assert kinds(0) == ["dev"]
    bits = []
    for s in range(len(tscan.index)):
        with tscan.open_shard(s) as r:
            bits += [int(v) * 8 for v in r.index.x_nbytes + r.index.y_nbytes]
    for cap in sorted(set(bits), reverse=True):   # the largest cap that mixes
        monkeypatch.setattr(tops, "_MAX_LAUNCH_BITS", cap)
        k = kinds(0)
        if "host" in k and k.count("dev") >= 2:
            break
    else:
        pytest.fail("no launch cap gives a row group with host and device chunks")
    monkeypatch.setattr(jops, "_MAX_LAUNCH_BITS", cap)
    subs = _submissions()
    jqs, jc = _serve(JServer, JRange, lakes[0], jds, "jax", subs, cache_rgs=64, max_wave=8)
    for device in PORT_DEVICES:
        qs, c = _serve(TServer, TRange, lakes[1], tds, device, subs, cache_rgs=64, max_wave=8)
        assert c == jc
        for q, jq in zip(qs, jqs):
            _assert_query_equal(q, jq, ("mixed", device, q.bbox))


def test_integer_coordinates_take_host_compares(tmp_path):
    jroot = _write(jsynth, jds, tmp_path / "ref", {}, int_coords=True)
    troot = _write(tsynth, tds, tmp_path / "port", {"device": "cpu"}, int_coords=True)
    box = tuple(float(v) * 1e5 for v in (-8.64, 41.14, -8.60, 41.17))
    subs = [(box, None, None), (None, None, None), (box, None, lambda R: R("tid", 5, 200))]
    with TServer(tds.SpatialDatasetScanner(troot), device="cpu") as srv:
        assert srv.device == "host"
    jqs, jc = _serve(JServer, JRange, jroot, jds, "jax", subs)
    qs, c = _serve(TServer, TRange, troot, tds, "cpu", subs)
    assert c == jc
    for q, jq in zip(qs, jqs):
        _assert_query_equal(q, jq, ("int", q.bbox))


def test_server_device_names(lakes):
    scanner = tds.SpatialDatasetScanner(lakes[1])
    with pytest.raises(ValueError, match="device must be"):
        TServer(scanner, device="jax")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TServer(scanner)


def _order_key_records(rng, dtype, n_rec=300):
    """Ragged records over negative and positive coordinates, with NaN, ±inf,
    ±0.0, records with no values and records that straddle the query edges."""
    counts = rng.integers(0, 6, n_rec)
    n = int(counts.sum())
    x = rng.uniform(-9.0, 9.0, n).astype(dtype)
    y = rng.uniform(-41.5, 41.5, n).astype(dtype)
    special = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0], dtype)
    for a in (x, y):
        hit = rng.random(n) < 0.05
        a[hit] = rng.choice(special, int(hit.sum()))
    return x, y, counts


@pytest.mark.parametrize("width", [32, 64])
def test_keep_from_minmax_matches_reference(rng, width):
    """The query-axis compare against the reference's ``_keep_from_minmax``
    on the same per-record keys (the port's 64-bit keys split into the
    reference's (lo, hi) limbs), NaN-bound rows masked as the reference
    masks them."""
    dtype = np.float32 if width == 32 else np.float64
    ibits = np.int32 if width == 32 else np.int64
    x, y, counts = _order_key_records(rng, dtype)
    n = len(x)
    bits = torch.from_numpy(np.concatenate([x, y]).view(ibits))
    starts = torch.from_numpy(np.cumsum(counts) - counts)
    c = torch.from_numpy(counts)
    valid = c > 0
    _, mm = tmm.segminmax_refine_ref(bits, starts, starts + n, c, valid,
                                     tmm.inf_keys64(width) * 2, width)
    boxes = [(-9.0, -41.5, 9.0, 41.5), (-8.0, -1.0, 0.0, 40.0), (-0.0, -0.0, 0.0, 0.0),
             (-np.inf, 0.0, np.inf, np.inf), (3.0, 3.0, -3.0, -3.0),
             (np.nan, 0.0, 1.0, 1.0), (-5.5, -20.25, -1.0, -3.0), (2.0, -41.0, 8.5, 41.0)]
    # the compare's own validity operand: a record set narrower than
    # "has values" (as a caller's attribute mask would make it)
    valid = valid & torch.from_numpy(rng.random(len(counts)) < 0.8)
    qkeys, qvalid = tmm.stack_bbox_query_keys(boxes, np.dtype(dtype))
    jq, jv = jmm.stack_bbox_query_keys(boxes, np.dtype(dtype))
    assert np.array_equal(qkeys, jq) and np.array_equal(qvalid, jv)
    got = tmm.keep_from_minmax(mm, valid, qkeys, qvalid, width).numpy()
    u = mm.numpy().view(np.uint64).T                       # (4, R) unsigned keys
    limbs = np.stack([u & 0xFFFFFFFF, u >> 32], 1).reshape(8, -1).astype(np.uint32)
    want = np.array(jops._keep_from_minmax(limbs, valid.numpy(), qkeys, width))
    want[~jv] = False
    assert np.array_equal(got, want)
    assert got[:, ~valid.numpy()].sum() == 0 and got.sum() > 0
    assert np.array_equal(refine_minmax_multi(mm, valid, qkeys, qvalid, width=width), got)


@pytest.mark.parametrize("device", ["cpu"])
def test_multi_refine_rows_equal_solo_refines(lakes, device):
    """Every row of ``decode_refine_stream_multi`` is the solo fused refine
    of that box; the all-invalid wave still decodes and keeps nothing."""
    boxes = [b for b in _boxes() if b is not None]
    with tds.SpatialDatasetScanner(lakes[1]).open_shard(1) as r:
        dtype = r.coord_dtype
        chunk = r.read_row_group(0, device=device).chunks[0]
    qkeys, qvalid = tmm.stack_bbox_query_keys(boxes, dtype)
    res = decode_refine_stream_multi(chunk.stream, chunk.aux, qkeys, qvalid, device=device)
    assert res.keep.shape == (len(boxes), chunk.aux.n_records)
    for i, b in enumerate(boxes):
        assert np.array_equal(res.keep[i], decode_refine_stream(
            chunk.stream, chunk.aux, b, device=device).keep), b
    nan_keys, nan_valid = tmm.stack_bbox_query_keys([(np.nan, 0.0, 1.0, 1.0)] * 2, dtype)
    res2 = decode_refine_stream_multi(chunk.stream, chunk.aux, nan_keys, nan_valid,
                                      device=device)
    assert not res2.keep.any()
    assert torch.equal(res2.bits, res.bits) and torch.equal(res2.mm, res.mm)
