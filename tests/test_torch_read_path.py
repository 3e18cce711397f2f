"""The port's writer and reader held against the JAX package's.

The same numpy columns (made from a seed) go through both writers, which
must write byte-identical files. Reads are compared field for field —
levels, coordinate bit patterns, extras and ``ReadStats`` — in two pairs:
the port's ``device="cpu"`` (its torch chain on CPU tensors) against the
reference's ``device="jax"`` (Pallas in interpret mode), and the port's
``device="host"`` against the reference's ``device="cpu"``. Each package
also reads the other's file.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core import columnar as jcol  # noqa: E402
from repro.core.filters import Range as JRange  # noqa: E402
from repro.core.reader import SpatialParquetReader as JReader  # noqa: E402
from repro.core.writer import write_file as j_write  # noqa: E402
from repro_torch.core import columnar as tcol  # noqa: E402
from repro_torch.core.columnar import TorchCoords  # noqa: E402
from repro_torch.core.filters import Range as TRange  # noqa: E402
from repro_torch.core.reader import SpatialParquetReader as TReader  # noqa: E402
from repro_torch.core.writer import write_file as t_write  # noqa: E402
from repro_torch.kernels.fp_delta import ops as tops  # noqa: E402

_TINY32 = np.finfo(np.float32).smallest_subnormal


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int64 if a.dtype.itemsize == 8 else np.int32)


def _trajectories(rng, n_rec=240, dtype=np.float64, empties=True):
    """MultiPoint random walks (Porto-taxi-like) as ragged numpy arrays; with
    ``empties``, empty records (some before an outsized record, so a
    coordinate page holds no values) and a trailing run of empties."""
    npts = rng.poisson(20, n_rec).clip(1, 80).astype(np.int64)
    if empties:
        npts[::9] = 0
        # an empty record between two records bigger than a page gets a
        # page of its own, with no coordinate values
        npts[40:43] = (300, 0, 300)
        npts[-5:] = 0
    total = int(npts.sum())
    start = np.repeat(rng.uniform([-8.7, 41.1], [-8.5, 41.25], (n_rec, 2)), npts, 0)
    walk = np.cumsum(rng.normal(0, 1.5e-4, (total, 2)), 0)
    coords = np.round(start + walk, 6)
    types = np.where(npts > 0, 4, 0).astype(np.uint8)  # MultiPoint or empty
    part_sizes = np.ones(total, np.int64)
    arrays = (types, coords, part_sizes, npts)
    return arrays, dtype


def _cols(mod, arrays, dtype):
    cols = mod.from_ragged(*arrays)
    if np.dtype(dtype) != np.float64:
        cols = dataclasses.replace(cols, x=cols.x.astype(dtype), y=cols.y.astype(dtype))
    return cols


def _extras(rng, n):
    f32 = rng.normal(0, 100, n).astype(np.float32)
    f32[::11] = np.nan
    f32[:20] = np.nan  # an all-NaN first page
    f32[25:27] = [-0.0, 0.0]
    f32[30] = _TINY32
    f32[31] = -_TINY32
    f64 = rng.normal(0, 1e6, n)
    f64[5::13] = np.nan
    f64[40:42] = [0.0, -0.0]
    return ({"f32": f32, "f64": f64,
             "i64": rng.integers(-(1 << 60), 1 << 60, n).astype(np.int64)},
            {"f32": "<f4", "f64": "<f8", "i64": "<i8"})


def _write_both(tmp_path, arrays, dtype, extra=None, schema=None, **kw):
    jp, tp = tmp_path / "ref.spqf", tmp_path / "port.spqf"
    j_write(jp, columns=_cols(jcol, arrays, dtype), extra=extra, extra_schema=schema, **kw)
    t_write(tp, columns=_cols(tcol, arrays, dtype), extra=extra, extra_schema=schema,
            device="cpu", **kw)
    return jp, tp


def assert_same_read(want, got, ctx=""):
    """Field-for-field equality of two (geometry, extras, stats) results."""
    gw, ew, sw = want
    gg, eg, sg = got
    assert (gw is None) == (gg is None), ctx
    if gw is not None:
        gw, gg = gw.coords_to_host(), gg.coords_to_host()
        for f in ("types", "type_rep", "rep", "defn"):
            assert np.array_equal(getattr(gw, f), getattr(gg, f)), (ctx, f)
        assert np.array_equal(_bits(gw.x), _bits(gg.x)), ctx
        assert np.array_equal(_bits(gw.y), _bits(gg.y)), ctx
    assert set(ew) == set(eg), ctx
    for k in ew:
        assert np.array_equal(_bits(ew[k]), _bits(eg[k])), (ctx, k)
    assert dataclasses.asdict(sw) == dataclasses.asdict(sg), ctx


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("checksums", [True, False])
@pytest.mark.parametrize("sort", [None, "hilbert"])
def test_files_byte_identical(tmp_path, rng, dtype, checksums, sort):
    """f32/f64 coordinates, f32/f64/int64 extras (NaN, all-NaN, ±0 and
    denormal pages), empty pages, several row groups, format v1 and v2."""
    arrays, dt = _trajectories(rng, dtype=dtype)
    extra, schema = _extras(rng, len(arrays[0]))
    jp, tp = _write_both(tmp_path, arrays, dt, extra, schema, page_values=64,
                         row_group_records=100, checksums=checksums, sort=sort)
    assert jp.read_bytes() == tp.read_bytes()
    with TReader(tp) as r:
        counts = [p["count"] for rg in r.footer["row_groups"] for p in rg["x_pages"]]
        if sort is None:
            assert 0 in counts  # an empty coordinate page was written
        assert len(r.footer["row_groups"]) == 3


@pytest.mark.parametrize("enc,codec,dtype", [
    ("fp_delta", "none", np.float64), ("raw", "gzip", np.float32),
])
def test_files_byte_identical_encodings(tmp_path, rng, enc, codec, dtype):
    arrays, dt = _trajectories(rng, n_rec=120, dtype=dtype)
    jp, tp = _write_both(tmp_path, arrays, dt, encoding=enc, codec=codec,
                         page_values=100)
    assert jp.read_bytes() == tp.read_bytes()


@pytest.fixture
def pt_files(tmp_path, rng):
    arrays, dt = _trajectories(rng, n_rec=300)
    extra, schema = _extras(rng, len(arrays[0]))
    jp, tp = _write_both(tmp_path, arrays, dt, extra, schema, page_values=256,
                         row_group_records=120, sort="hilbert")
    with JReader(jp) as r:
        g0, _, _ = r.read_columnar()
    return jp, tp, g0


def _qbox(g0, lo, hi):
    x, y = np.asarray(g0.x), np.asarray(g0.y)
    return (float(np.quantile(x, lo)), float(np.quantile(y, lo)),
            float(np.quantile(x, hi)), float(np.quantile(y, hi)))


def test_reads_match_reference(pt_files):
    """A selectivity sweep, a NaN bbox, an empty refine, projections and
    plain reads: port cpu == reference jax, port host == reference cpu."""
    jp, tp, g0 = pt_files
    boxes = {"p01": _qbox(g0, 0.0, 0.1), "p10": _qbox(g0, 0.0, 0.32),
             "p50": _qbox(g0, 0.1, 0.8), "full": _qbox(g0, 0.0, 1.0),
             "nan": (np.nan, 0.0, 1.0, 1.0),
             "miss": (0.0, 0.0, 1.0, 1.0)}
    with JReader(jp) as jr, TReader(tp) as tr:
        for name, bbox in boxes.items():
            want = jr.read_columnar(bbox=bbox, refine=True, device="jax")
            assert_same_read(want, tr.read_columnar(bbox=bbox, refine=True, device="cpu"),
                             name)
            assert_same_read(jr.read_columnar(bbox=bbox, refine=True, device="cpu"),
                             tr.read_columnar(bbox=bbox, refine=True, device="host"), name)
        b = boxes["p50"]
        assert_same_read(jr.read_columnar(bbox=b, device="jax"),
                         tr.read_columnar(bbox=b, device="cpu"), "no refine")
        assert_same_read(jr.read_columnar(), tr.read_columnar(device="host"), "full")
        cols = ("geometry", "f32")
        assert_same_read(jr.read_columnar(bbox=b, columns=cols, refine=True, device="jax"),
                         tr.read_columnar(bbox=b, columns=cols, refine=True, device="cpu"),
                         "projection")


def test_filter_reads_match_reference(pt_files):
    jp, tp, g0 = pt_files
    b = _qbox(g0, 0.05, 0.7)
    with JReader(jp) as jr, TReader(tp) as tr:
        for lo, hi in ((-50.0, 80.0), (None, 0.0), (-0.0, 0.0)):
            jf, tf = JRange("f32", lo, hi), TRange("f32", lo, hi)
            assert_same_read(
                jr.read_columnar(bbox=b, refine=True, filter=jf, device="jax"),
                tr.read_columnar(bbox=b, refine=True, filter=tf, device="cpu"), (lo, hi))
            assert_same_read(
                jr.read_columnar(bbox=b, filter=jf, device="jax"),
                tr.read_columnar(bbox=b, filter=tf, device="cpu"), ("no refine", lo, hi))
            assert_same_read(
                jr.read_columnar(bbox=b, refine=True, filter=jf, device="cpu"),
                tr.read_columnar(bbox=b, refine=True, filter=tf, device="host"),
                ("host", lo, hi))


def test_keep_on_device_reads(pt_files):
    jp, tp, g0 = pt_files
    b = _qbox(g0, 0.0, 0.6)
    with JReader(jp) as jr, TReader(tp) as tr:
        want = jr.read_columnar(bbox=b, refine=True, device="jax", keep_on_device=True)
        got = tr.read_columnar(bbox=b, refine=True, device="cpu", keep_on_device=True)
        assert isinstance(got[0].x, TorchCoords) and got[0].x.bits.device.type == "cpu"
        assert len(got[0].x) == len(want[0].x)
        assert_same_read(want, got, "keep_on_device")
        full = tr.read_columnar(device="cpu", keep_on_device=True)
        assert np.array_equal(_bits(full[0].coords_to_host().x), _bits(g0.x))
        with pytest.raises(ValueError, match="keep_on_device"):
            tr.read_columnar(device="host", keep_on_device=True)
        with pytest.raises(ValueError, match="device must be"):
            tr.read_columnar(device="jax")


def test_chunking_and_host_pair_fallback(pt_files, monkeypatch):
    """With the port's launch cap made small the fused path splits page
    pairs across launches, then host-decodes pairs too large for any
    launch: the same result as the reference either way."""
    jp, tp, g0 = pt_files
    b = _qbox(g0, 0.0, 0.6)
    with JReader(jp) as jr, TReader(tp) as tr:
        want = jr.read_columnar(bbox=b, refine=True, device="jax")
        for cap in (8192, 1024):
            monkeypatch.setattr(tops, "_MAX_LAUNCH_BITS", cap)
            assert_same_read(want, tr.read_columnar(bbox=b, refine=True, device="cpu"), cap)
            got = tr.read_columnar(bbox=b, refine=True, device="cpu", keep_on_device=True)
            assert_same_read(want, got, ("keep_on_device", cap))


def test_cross_reads(pt_files):
    """Each package reads the other's file."""
    jp, tp, g0 = pt_files
    b = _qbox(g0, 0.0, 0.5)
    with JReader(tp) as jr, TReader(jp) as tr:
        assert_same_read(jr.read_columnar(bbox=b, refine=True, device="jax"),
                         tr.read_columnar(bbox=b, refine=True, device="cpu"), "cross")
        assert_same_read(jr.read_columnar(), tr.read_columnar(device="host"), "cross full")


def test_float32_raw_gzip_reads(tmp_path, rng):
    arrays, dt = _trajectories(rng, n_rec=150, dtype=np.float32)
    jp, tp = _write_both(tmp_path, arrays, dt, encoding="raw", codec="gzip",
                         page_values=128, row_group_records=70)
    with JReader(jp) as jr, TReader(tp) as tr:
        g0, _, _ = jr.read_columnar()
        for frac in (0.2, 0.7):
            b = _qbox(g0, 0.0, frac)
            assert_same_read(jr.read_columnar(bbox=b, refine=True, device="jax"),
                             tr.read_columnar(bbox=b, refine=True, device="cpu"), frac)


def test_integer_coordinates_refine_on_host(tmp_path, rng):
    """int64 coordinates decode on the device and refine on the host, as
    in the reference."""
    arrays, _ = _trajectories(rng, n_rec=80)
    types, coords, parts, npts = arrays
    ints = (coords * 1e6).astype(np.int64)
    jc = dataclasses.replace(jcol.from_ragged(*arrays), x=ints[:, 0].copy(), y=ints[:, 1].copy())
    tc = dataclasses.replace(tcol.from_ragged(*arrays), x=ints[:, 0].copy(), y=ints[:, 1].copy())
    jp, tp = tmp_path / "ref.spqf", tmp_path / "port.spqf"
    j_write(jp, columns=jc, page_values=128)
    t_write(tp, columns=tc, page_values=128, device="cpu")
    assert jp.read_bytes() == tp.read_bytes()
    b = (float(ints[:, 0].min()), float(ints[:, 1].min()),
         float(np.median(ints[:, 0])), float(np.median(ints[:, 1])))
    with JReader(jp) as jr, TReader(tp) as tr:
        assert_same_read(jr.read_columnar(bbox=b, refine=True, device="jax"),
                         tr.read_columnar(bbox=b, refine=True, device="cpu"), "int")
        with pytest.raises(ValueError, match="float coordinates"):
            tr.read_columnar(bbox=b, refine=True, device="cpu", keep_on_device=True)


def _chunk_coords(data):
    """x, y of a row group read on a device: its chunks' streams decoded on
    the CPU (x and y pages interleave in a stream) and host chunks' values,
    in record order."""
    xs, ys = [], []
    for ch in data.chunks:
        if ch.kind == "host":
            xs.append(ch.x)
            ys.append(ch.y)
            continue
        vals = tops.decode_page_stream(ch.stream, device="cpu")
        pages = np.split(vals, np.cumsum(ch.stream.counts)[:-1])
        xs += pages[0::2]
        ys += pages[1::2]
    return np.concatenate(xs), np.concatenate(ys)


def test_read_row_group_matches_reference(pt_files):
    """``"host"`` against the reference's ``"cpu"`` (decoded arrays);
    ``"cpu"`` against the same through its unlaunched chunks, whose record
    ranges tile the row group."""
    jp, tp, _ = pt_files
    with JReader(jp) as jr, TReader(tp) as tr:
        for rg, device in itertools.product(range(len(jr.footer["row_groups"])),
                                            ("host", "cpu")):
            a, b = jr.read_row_group(rg), tr.read_row_group(rg, device=device)
            assert a.n_records == b.n_records and a.nbytes == b.nbytes
            assert np.array_equal(a.rec_vcounts, b.rec_vcounts)
            if device == "host":
                assert b.chunks is None
                bx, by = b.x, b.y
            else:
                assert b.x is None and b.y is None
                assert b.chunks[0].rec_lo == 0 and b.chunks[-1].rec_hi == b.n_records
                assert all(c.rec_hi == d.rec_lo for c, d in zip(b.chunks, b.chunks[1:]))
                bx, by = _chunk_coords(b)
            assert np.array_equal(_bits(a.x), _bits(bx))
            assert np.array_equal(_bits(a.y), _bits(by))
            for k in a.extras:
                assert np.array_equal(_bits(a.extras[k]), _bits(b.extras[k]))


def test_default_device_needs_a_card(pt_files, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tp, _ = pt_files
    with TReader(tp) as tr:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tr.read_columnar(bbox=(0.0, 0.0, 1.0, 1.0), refine=True)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tr.read_row_group(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_write(tmp_path / "x.spqf", columns=tcol.from_ragged(
            *_trajectories(np.random.default_rng(1), n_rec=60)[0]))
