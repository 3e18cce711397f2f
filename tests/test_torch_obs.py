"""The port's read-path spans (``repro_torch.obs``): where each one opens,
under which parent and on which thread, that tracing leaves the answer's
bits as they are, and that with tracing off a read builds no span.

A small Porto-like file with extra columns and several row groups, read
with ``read_columnar(bbox, refine=True, device="cpu")``: the fused path with
the kernels' plain versions and the prefetch thread.
"""

import dataclasses
import threading

import numpy as np
import pytest

from repro_torch import obs
from repro_torch.core.reader import SpatialParquetReader
from repro_torch.core.writer import write_file
from repro_torch.data.synthetic import PORTO_BBOX, porto_taxi_like
from repro_torch.obs.trace import Span

BBOX = (-8.66, 41.13, -8.55, 41.21)

# new span -> the spans it may open under (None: no parent)
PARENTS = {
    "stream.build": {"rg.launch"},
    "stream.aux": {"rg.launch"},
    "page.plan": {"rg.plan"},
    "rg.checksum": {"rg.plan", "rg.levels", "rg.extras"},
    "rg.extras": {"rg.plan"},
    "rg.wait": {"scan.file"},
    "scan.index": {"scan.file"},
    "scan.assemble": {"scan.file"},
    "rg.value_counts": {"scan.file"},
    "reader.open": {None},
    # the spans the benchmark reads
    "rg.plan": {"scan.file"},
    "rg.launch": {"scan.file"},
    "rg.gather": {"scan.file"},
    "device.h2d": {"rg.launch"},
    "device.decode_launch": {"rg.launch"},
    "device.refine_launch": {"rg.launch"},
    "device.gather": {"rg.gather"},
}


@pytest.fixture(scope="module")
def porto_file(tmp_path_factory):
    cols = porto_taxi_like(n_traj=2500, mean_pts=24, seed=3)
    n = cols.n_records
    rng = np.random.default_rng(4)
    extras = {"timestamp": rng.integers(1_372_636_800, 1_404_172_800, n).astype(np.int64),
              "duration_s": rng.gamma(2.0, 300.0, n).astype(np.float32)}
    path = tmp_path_factory.mktemp("obs") / "porto.spqf"
    write_file(path, columns=cols, extra=extras,
               extra_schema={"timestamp": "<i8", "duration_s": "<f4"},
               sort="hilbert", page_values=2048, row_group_records=600, device="cpu")
    return path


@pytest.fixture
def telemetry_off_after():
    yield
    obs.disable()


def _read(path):
    with SpatialParquetReader(path) as r:
        return r.read_columnar(BBOX, refine=True, device="cpu")


def _traced_read(path):
    tracer = obs.enable()
    try:
        res = _read(path)
    finally:
        obs.disable()
    return res, tracer


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int64 if a.dtype.itemsize == 8 else np.int32)


def test_the_file_has_what_the_spans_need(porto_file):
    with SpatialParquetReader(porto_file) as r:
        assert len(r.footer["row_groups"]) >= 3 and r.extra_schema
        assert r.index.query(BBOX).size < len(r.index)       # the index prunes
    assert PORTO_BBOX[0] < BBOX[0] < BBOX[2] < PORTO_BBOX[2]


def test_traced_read_returns_the_same_bits(porto_file, telemetry_off_after):
    geo0, ex0, st0 = _read(porto_file)
    (geo1, ex1, st1), _ = _traced_read(porto_file)
    assert geo0.n_records > 0
    for f in ("types", "type_rep", "rep", "defn"):
        np.testing.assert_array_equal(getattr(geo0, f), getattr(geo1, f))
    np.testing.assert_array_equal(_bits(geo0.x), _bits(geo1.x))
    np.testing.assert_array_equal(_bits(geo0.y), _bits(geo1.y))
    assert set(ex0) == set(ex1) == {"timestamp", "duration_s"}
    for k in ex0:
        np.testing.assert_array_equal(_bits(ex0[k]), _bits(ex1[k]))
    assert dataclasses.asdict(st0) == dataclasses.asdict(st1)


def test_each_new_span_opens_under_its_parent_on_the_calling_thread(
        porto_file, telemetry_off_after):
    (geo, _, stats), tracer = _traced_read(porto_file)
    spans = tracer.spans()
    by_id = {s["args"]["span_id"]: s for s in spans}
    me = threading.get_ident()
    for name, parents in PARENTS.items():
        mine = [s for s in spans if s["name"] == name]
        assert mine, f"no {name} span"
        for s in mine:
            pid = s["args"]["parent_id"]
            parent = by_id[pid]["name"] if pid else None
            assert parent in parents, (name, parent)
            assert s["tid"] == me, name
    # the checksums of coordinate pages sit in rg.plan itself
    plans = {s["args"]["span_id"] for s in spans if s["name"] == "rg.plan"}
    assert any(s["args"]["parent_id"] in plans for s in spans if s["name"] == "rg.checksum")
    # the prefetch thread's fetches are the other side of rg.wait
    assert any(s["name"] == "rg.fetch" and s["tid"] != me for s in spans)
    # the spans' arguments
    stream = next(s for s in spans if s["name"] == "stream.build")["args"]
    assert stream["pages"] > 0 and stream["values"] > 0
    plan = next(s for s in spans if s["name"] == "page.plan")["args"]
    assert plan["encoding"] == "fp_delta" and plan["values"] > 0
    assert next(s for s in spans if s["name"] == "rg.checksum")["args"]["bytes"] > 0
    assert next(s for s in spans if s["name"] == "stream.aux")["args"]["records"] > 0

    def args(name):
        return [s["args"] for s in spans if s["name"] == name]

    # every row group here is one launch chunk: the launches cover the
    # records and values the read scanned, and the gathers its survivors
    decodes, refines = args("device.decode_launch"), args("device.refine_launch")
    assert len(decodes) == len(refines) == len(args("device.h2d"))
    for d, f, h in zip(decodes, refines, args("device.h2d")):
        assert d["width"] == f["width"] == 64
        assert d["values"] == f["values"] == h["values"] > 0
    assert sum(f["records"] for f in refines) == stats.records_scanned
    gathers = args("device.gather")
    assert len(gathers) == 2 * len(refines)
    assert not any(g["on_device"] for g in gathers)
    assert sum(g["values"] for g in gathers) == 2 * geo.n_values


@pytest.mark.parametrize("path,read", [
    ("unfused", lambda r: r.read_columnar(BBOX, device="cpu")),
    ("row group", lambda r: r.read_row_group(1, device="cpu")),
])
def test_the_other_read_paths_get_the_same_names(porto_file, telemetry_off_after, path, read):
    tracer = obs.enable()
    try:
        with SpatialParquetReader(porto_file) as r:
            read(r)
    finally:
        obs.disable()
    names = {s["name"] for s in tracer.spans()}
    assert {"reader.open", "page.plan", "rg.checksum", "rg.extras", "stream.build"} <= names
    if path == "row group":
        assert {"stream.aux", "rg.value_counts"} <= names
    if path == "unfused":
        assert {"scan.index", "scan.assemble", "rg.wait"} <= names


def test_host_cpu_per_gb_is_one_histogram(porto_file, telemetry_off_after):
    _traced_read(porto_file)
    snap = obs.snapshot()
    assert set(snap) == {"counters", "histograms"}
    hists = snap["histograms"]
    assert hists["scan.host_cpu_s_per_gb"]["count"] == 1
    assert not [k for k in hists if k.endswith("_hist") or k.startswith("io.read")]


def test_with_tracing_off_a_read_builds_no_span(porto_file, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span was built with tracing off")

    monkeypatch.setattr(Span, "__init__", refuse)
    assert not obs.enabled()
    geo, extras, stats = _read(porto_file)
    assert geo.n_records > 0 and stats.pages_read > 0 and extras["timestamp"].size
    # the patch does catch a span when tracing is on
    obs.enable()
    try:
        with pytest.raises(AssertionError, match="span was built"):
            _read(porto_file)
    finally:
        obs.disable()
