"""Multi-part geometries through the port's read path, and the packed level codec.

Roads (``roads_like``: MultiLineStrings of 1-3 lines, repetition levels 0, 2
and 3 in one record) and buildings (``buildings_like``: Polygons of one
five-point ring) are the shapes whose repetition streams the writer
bit-packs rather than run-length encodes. Small files of each, with several
row groups and pages, are read with ``read_columnar(bbox, refine=True)`` on
the host path and on the fused path with ``device="cpu"``, and each answer
is held field for field to the JAX package's reader on the same file (its
``cpu`` and ``jax`` paths). ``tests/test_torch_read_path.py`` holds the two
writers' files of these shapes byte for byte.

The level codec's byte-table path (widths 1 and 2, the level streams'
widths) is held bit for bit to the bit stream (``pack_tokens`` /
``unpack_fixed``), which other widths take, and ``encode_levels`` /
``decode_levels`` to the JAX package's on the same streams. One case, marked
``cuda``, reads a roads file on the card and compares it with the CPU path,
which the cases above hold to the reference. A Porto-like file with empty
records and empty parts is read on the fused path (``cpu``, and ``cuda`` on
the card) and held to the host path, with the empty slots the value count
subtracted (counter ``levels.empty_slots``).
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import rle
from repro_torch.core.bitstream import bytes_to_words, pack_tokens, unpack_fixed, words_to_bytes
from repro_torch.core.columnar import from_ragged
from repro_torch.core.reader import SpatialParquetReader
from repro_torch.core.writer import write_file
from repro_torch.data.synthetic import buildings_like, ebird_like, porto_taxi_like, roads_like

WRITER = dict(page_values=2048, row_group_records=700, sort="hilbert", sfc_order=16,
              checksums=True)
# boxes as shares of the data's extent: a region, a band, the whole extent,
# and one that lies outside the data
BOXES = {"region": (0.2, 0.2, 0.55, 0.6), "band": (0.0, 0.0, 1.0, 0.3),
         "all": (-0.01, -0.01, 1.01, 1.01), "outside": (1.1, 1.1, 1.3, 1.3)}
# the port's read path and the reference's path it is held to
REF_DEVICE = {"host": "cpu", "cpu": "jax"}


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int64 if a.dtype.itemsize == 8 else np.int32)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """kind -> (path, generated columns)."""
    d = tmp_path_factory.mktemp("multipart")
    out = {}
    for kind, cols in (("roads", roads_like(1800, seed=5)),
                       ("buildings", buildings_like(3000, seed=6))):
        path = d / f"{kind}.spqf"
        write_file(path, columns=cols, device="cpu", **WRITER)
        out[kind] = (path, cols)
    return out


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's modules the port is held to."""
    pytest.importorskip("jax")
    from repro.core import rle as jrle
    from repro.core.reader import SpatialParquetReader as JReader
    return jrle, JReader


def _box(cols, shares):
    x0, x1, y0, y1 = cols.x.min(), cols.x.max(), cols.y.min(), cols.y.max()
    a, b, c, d = shares
    return (float(x0 + a * (x1 - x0)), float(y0 + b * (y1 - y0)),
            float(x0 + c * (x1 - x0)), float(y0 + d * (y1 - y0)))


def _records_meeting(cols, bbox):
    """How many records' bboxes meet ``bbox``, from the generated columns."""
    starts = np.flatnonzero(cols.rep == 0)
    x0, y0, x1, y1 = bbox
    return int(np.count_nonzero(
        (np.minimum.reduceat(cols.x, starts) <= x1) & (np.maximum.reduceat(cols.x, starts) >= x0)
        & (np.minimum.reduceat(cols.y, starts) <= y1) & (np.maximum.reduceat(cols.y, starts) >= y0)))


def _read(path, bbox, device):
    with SpatialParquetReader(path) as r:
        return r.read_columnar(bbox, refine=True, device=device)


def _answer(res):
    geo = res[0]
    if geo is None:
        e8, e64 = np.zeros(0, np.uint8), np.zeros(0, np.float64)
        return 0, e8, e8, e8, e8, e64, e64
    geo = geo.coords_to_host()
    return geo.n_records, geo.rep, geo.defn, geo.types, geo.type_rep, geo.x, geo.y


def _assert_same(got, want, ctx):
    assert got[0] == want[0], ctx
    for name, g, w in zip(("rep", "defn", "types", "type_rep"), got[1:5], want[1:5]):
        assert g.dtype == np.uint8 and np.array_equal(g, w), (ctx, name)
    for name, g, w in zip(("x", "y"), got[5:], want[5:]):
        assert np.array_equal(_bits(g), _bits(w)), (ctx, name)


def test_the_files_have_packed_rep_streams_and_several_row_groups(files):
    for kind, (path, cols) in files.items():
        raw = path.read_bytes()
        with SpatialParquetReader(path) as r:
            rgs = r.footer["row_groups"]
            assert len(rgs) >= 3 and len(r.index) > len(rgs), kind
        assert all(raw[rg["rep"]["offset"]] == rle.MODE_PACKED for rg in rgs), kind
    assert set(np.unique(files["roads"][1].rep)) == {0, 2, 3}
    assert set(np.unique(files["buildings"][1].rep)) == {0, 3}


@pytest.mark.parametrize("device", ["host", "cpu"])
@pytest.mark.parametrize("box", sorted(BOXES))
@pytest.mark.parametrize("kind", ["roads", "buildings"])
def test_a_refined_read_equals_the_expectation(files, jax_ref, kind, box, device):
    _, JReader = jax_ref
    path, cols = files[kind]
    bbox = _box(cols, BOXES[box])
    n = _records_meeting(cols, bbox)
    if box == "outside":
        assert n == 0
    elif box == "all":
        assert n == cols.n_records
    else:
        assert 0 < n < cols.n_records
    with JReader(path) as jr:
        want = jr.read_columnar(bbox, refine=True, device=REF_DEVICE[device])
    got = _read(path, bbox, device)
    assert _answer(got)[0] == n
    _assert_same(_answer(got), _answer(want), (kind, box, device))
    assert dataclasses.asdict(got[2]) == dataclasses.asdict(want[2]), (kind, box, device)


def test_the_packed_branch_is_traced(files):
    path, cols = files["roads"]
    with SpatialParquetReader(path) as r:
        rgs = r.footer["row_groups"]
    tracer = obs.enable()
    try:
        _read(path, _box(cols, BOXES["all"]), "cpu")
        counters = obs.snapshot()["counters"]
    finally:
        obs.disable()
    spans = tracer.spans()
    by_id = {s["args"]["span_id"]: s for s in spans}
    unpack = [s for s in spans if s["name"] == "levels.unpack"]
    assert unpack
    for s in unpack:
        assert by_id[s["args"]["parent_id"]]["name"] == "rg.levels"
        assert s["tid"] == threading.get_ident()
        assert s["args"]["width"] == 2 and s["args"]["values"] > 0
    levels = [s for s in spans if s["name"] == "rg.levels"]
    assert sorted(s["args"]["slots"] for s in levels) == sorted(rg["n_values"] for rg in rgs)
    # every row group's rep stream is packed; its type_rep (one a record)
    # and defn (one a slot) streams are run-length encoded
    assert len(unpack) == len(rgs)
    assert counters["levels.packed_values"] == sum(rg["n_values"] for rg in rgs)
    assert counters["levels.rle_values"] == sum(rg["n_records"] + rg["n_values"] for rg in rgs)


# ------------------------------------------------- empty records and parts
@pytest.fixture(scope="module")
def empties_file(tmp_path_factory):
    """Porto-like trips with empty records (leading, trailing, runs of
    them) and records of two sub-geometries of which one is empty, and two
    extra columns: (path, columns)."""
    rng = np.random.default_rng(11)
    types, coords, part_sizes, pps, spr = porto_taxi_like(2000, mean_pts=12, seed=8).to_ragged()
    n = len(spr)
    rec = np.sort(rng.choice(n, 60, replace=False))
    spr = spr.copy()
    spr[rec] = 2                                  # an empty part first, or second
    at = rec + np.arange(len(rec)) % 2
    types, pps = np.insert(types, at, types[rec]), np.insert(pps, at, 0)
    sub = np.cumsum(spr) - spr                    # each record's first sub-geometry
    at = np.concatenate([[0, 0], np.repeat(sub[rng.choice(n, 20, replace=False)], 3),
                         [len(types)] * 4])       # empty records
    cols = from_ragged(np.insert(types, at, 0), coords, part_sizes, np.insert(pps, at, 0),
                       np.insert(spr, np.searchsorted(sub, at), 1))
    extra = {"t": rng.integers(0, 1 << 40, cols.n_records),
             "v": rng.normal(0, 1, cols.n_records).astype(np.float32)}
    path = tmp_path_factory.mktemp("empties") / "empties.spqf"
    write_file(path, columns=cols, extra=extra, extra_schema={"t": "<i8", "v": "<f4"},
               device="cpu", **WRITER)
    return path, cols


def _counted_empty_slots(fn):
    obs.enable()
    try:
        out = fn()
        return out, obs.snapshot()["counters"].get("levels.empty_slots", 0)
    finally:
        obs.disable()


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("box", ["region", "all"])
def test_a_read_with_empties_equals_the_host_path(empties_file, box, device):
    """The fused refined read equals the host path's (levels, x and y bits,
    extras, stats); ``levels.empty_slots`` counts the empty slots of the
    records it scanned, and ``read_row_group`` those of its whole group."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    path, cols = empties_file
    empty = cols.defn == 0
    starts = np.flatnonzero(cols.rep == 0)
    one_slot = np.diff(starts, append=len(cols.rep)) == 1
    assert (empty[starts] & one_slot).sum() == 66 and empty.sum() == 66 + 60
    bbox = _box(cols, BOXES[box])
    with SpatialParquetReader(path) as r:
        want = r.read_columnar(bbox, refine=True, device="host")
        got, n_empty = _counted_empty_slots(
            lambda: r.read_columnar(bbox, refine=True, device=device))
        scanned = r.read_columnar(bbox, device="host")
        rgs = r.footer["row_groups"]
        assert len(rgs) >= 3
        for rg_i, rg in enumerate(rgs):
            data, rg_empty = _counted_empty_slots(lambda: r.read_row_group(rg_i, device=device))
            assert data.n_records == rg["n_records"]
            assert rg_empty == int(np.count_nonzero(data.levels.defn == 0))
    _assert_same(_answer(got), _answer(want), (box, device))
    assert set(got[1]) == {"t", "v"}
    for k in got[1]:
        assert np.array_equal(_bits(got[1][k]), _bits(want[1][k])), k
    assert dataclasses.asdict(got[2]) == dataclasses.asdict(want[2])
    # every record of the hit pages: the records the count looked at
    assert scanned[0].n_records == want[2].records_scanned
    assert n_empty == int(np.count_nonzero(scanned[0].defn == 0))
    if box == "all":
        assert n_empty == int(empty.sum())
    else:
        assert 0 < want[0].n_records < cols.n_records


# ---------------------------------------------------------------- the codec
def _stream(fill, n, width, seed=0):
    if fill == "zero":
        return np.zeros(n, np.uint8)
    if fill == "max":
        return np.full(n, (1 << width) - 1, np.uint8)
    return np.random.default_rng(seed).integers(0, 1 << width, n).astype(np.uint8)


@pytest.mark.parametrize("fill", ["zero", "max", "random"])
@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 4097])
@pytest.mark.parametrize("width", range(1, 9))
def test_packed_levels_equal_the_bit_stream(width, n, fill):
    values = _stream(fill, n, width, seed=width * 10_000 + n)
    words, total = pack_tokens(values.astype(np.uint64), np.full(n, width, np.int64))
    want = words_to_bytes(words, total)
    assert rle.pack_levels(values, width) == want
    got = rle.unpack_levels(want, n, width)
    assert got.dtype == np.uint8 and got.shape == (n,)
    assert np.array_equal(got, unpack_fixed(bytes_to_words(want), 0, n, width).astype(np.uint8))
    assert np.array_equal(got, values)


SHAPES = {"porto": lambda: porto_taxi_like(1500, seed=1),
          "ebird": lambda: ebird_like(4000, seed=2),
          "roads": lambda: roads_like(1500, seed=3),
          "buildings": lambda: buildings_like(1500, seed=4)}


@pytest.mark.parametrize("stream", ["type_rep", "rep", "defn"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_encode_levels_keeps_the_mode_and_the_bytes(jax_ref, shape, stream):
    jrle, _ = jax_ref
    values = getattr(SHAPES[shape](), stream)
    buf = rle.encode_levels(values)
    assert buf == jrle.encode_levels(values)
    packed = shape in ("roads", "buildings") and stream == "rep"
    assert buf[0] == (rle.MODE_PACKED if packed else rle.MODE_RLE)
    out = rle.decode_levels(buf)
    assert out.dtype == np.uint8 and np.array_equal(out, values)
    assert np.array_equal(out, jrle.decode_levels(buf))


@pytest.mark.parametrize("width", [2, 3])
def test_decode_levels_reads_a_slice_of_a_larger_buffer(width):
    """Uncompressed level blobs arrive as memoryview slices of one read."""
    values = _stream("random", 1001, width, seed=5)
    values[1:] |= 1          # no long runs: packing wins
    buf = rle.encode_levels(values)
    assert buf[0] == rle.MODE_PACKED and buf[1] == width
    whole = memoryview(b"\xff" * 13 + buf + b"\xff" * 11)
    out = rle.decode_levels(whole[13:13 + len(buf)])
    assert np.array_equal(out, values)


# ---------------------------------------------------------------- the card
@pytest.mark.cuda
def test_a_roads_read_on_the_card_equals_the_cpu(files):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    path, cols = files["roads"]
    for box in ("region", "band", "all"):
        bbox = _box(cols, BOXES[box])
        want = _answer(_read(path, bbox, "cpu"))
        _assert_same(_answer(_read(path, bbox, "cuda")), want, box)
