"""The port's baseline formats held against the JAX package's.

WKB, the GeoParquet-like file, GeoJSON and the Shapefile are the comparison
formats of the paper's storage and read-time experiments. The port keeps
copies of them; each case writes the same geometries through both packages
(the reference's random geometries, rebuilt as the port's ``Geometry``) and
requires equal bytes, then equal geometries read back. Tolerance: exact.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import repro.baselines.geojson_format as jgj  # noqa: E402
import repro.baselines.geoparquet_like as jgq  # noqa: E402
import repro.baselines.shapefile as jshp  # noqa: E402
import repro.baselines.wkb as jwkb  # noqa: E402
import repro.core.columnar as jcol  # noqa: E402
import repro.data.synthetic as jsynth  # noqa: E402
import repro_torch.baselines.geojson_format as tgj  # noqa: E402
import repro_torch.baselines.geoparquet_like as tgq  # noqa: E402
import repro_torch.baselines.shapefile as tshp  # noqa: E402
import repro_torch.baselines.wkb as twkb  # noqa: E402
import repro_torch.core.columnar as tcol  # noqa: E402
import repro_torch.data.synthetic as tsynth  # noqa: E402
from repro_torch.core.geometry import TYPE_MULTILINESTRING, Geometry  # noqa: E402
from repro_torch.core.writer import write_file as t_write  # noqa: E402
from tests.geom_helpers import random_geometry  # noqa: E402


def _port_geom(g) -> Geometry:
    return Geometry(g.geom_type, [p.copy() for p in g.parts],
                    [_port_geom(s) for s in g.sub_geometries])


def _random_pairs(n):
    ref = [random_geometry(np.random.default_rng(s)) for s in range(n)]
    return ref, [_port_geom(g) for g in ref]


def _assert_geoms_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.geom_type == y.geom_type and len(x.parts) == len(y.parts)
        assert all(np.array_equal(p.view(np.int64), q.view(np.int64))
                   for p, q in zip(x.parts, y.parts))
        _assert_geoms_equal(x.sub_geometries, y.sub_geometries)


def test_wkb_bytes_equal_reference():
    ref, port = _random_pairs(60)
    for jg, tg in zip(ref, port):
        buf = twkb.geometry_to_wkb(tg)
        assert buf == jwkb.geometry_to_wkb(jg)
        back, off = twkb.wkb_to_geometry(buf)
        jback, joff = jwkb.wkb_to_geometry(buf)
        assert off == joff == len(buf)
        _assert_geoms_equal([back], [jback])


@pytest.mark.parametrize("gz", [False, True])
def test_geojson_bytes_equal_reference(tmp_path, gz):
    ref, port = _random_pairs(40)
    jp, tp = tmp_path / "ref.geojson", tmp_path / "port.geojson"
    jgj.write_geojson(jp, ref, gz=gz)
    tgj.write_geojson(tp, port, gz=gz)
    if gz:   # the gzip header stamps the write time: compare the members
        import gzip
        assert gzip.decompress(tp.read_bytes()) == gzip.decompress(jp.read_bytes())
    else:
        assert tp.read_bytes() == jp.read_bytes()
    _assert_geoms_equal(tgj.read_geojson(tp, gz=gz), jgj.read_geojson(jp, gz=gz))


@pytest.mark.parametrize("codec", ["none", "gzip"])
def test_geoparquet_like_bytes_and_reads_equal_reference(tmp_path, codec):
    jgeoms = jcol.assemble(jsynth.porto_taxi_like(n_traj=500, seed=3))
    tgeoms = tcol.assemble(tsynth.porto_taxi_like(n_traj=500, seed=3))
    jp, tp = tmp_path / "ref.gpq", tmp_path / "port.gpq"
    with jgq.GeoParquetLikeWriter(jp, codec=codec, page_records=64) as w:
        w.write_geometries(jgeoms)
    with tgq.GeoParquetLikeWriter(tp, codec=codec, page_records=64) as w:
        w.write_geometries(tgeoms)
    assert tp.read_bytes() == jp.read_bytes()
    jr, tr = jgq.GeoParquetLikeReader(jp), tgq.GeoParquetLikeReader(tp)
    try:
        for bbox in (None, tgeoms[0].bbox(), (-8.64, 41.14, -8.60, 41.17)):
            (a, pr, pt), (b, jpr, jpt) = tr.read(bbox=bbox), jr.read(bbox=bbox)
            assert (pr, pt) == (jpr, jpt) and len(a) >= 1
            _assert_geoms_equal(a, b)
    finally:
        jr.close()
        tr.close()


def test_shapefile_bytes_equal_reference(tmp_path):
    rng = np.random.default_rng(0)
    lines = [[rng.normal(0, 1, (4, 2)), rng.normal(0, 1, (3, 2))] for _ in range(20)]
    port = [Geometry.multilinestring(ls) for ls in lines]
    ref = [jshp.Geometry.multilinestring(ls) for ls in lines]
    jp, tp = tmp_path / "ref.shp", tmp_path / "port.shp"
    jshp.write_shapefile(jp, ref)
    tshp.write_shapefile(tp, port)
    assert tp.read_bytes() == jp.read_bytes()
    back = tshp.read_shapefile(tp)
    assert all(g.geom_type == TYPE_MULTILINESTRING for g in back)
    _assert_geoms_equal(back, jshp.read_shapefile(jp))


def test_paper_claim_spatialparquet_smallest(tmp_path):
    """Table 2 direction at test scale, through the port's writers:
    SP(fp-delta) < WKB-based < GeoJSON."""
    cols = tsynth.porto_taxi_like(n_traj=1500, seed=4)
    geoms = tcol.assemble(cols)
    p_sp, p_gq, p_gj = tmp_path / "a.spqf", tmp_path / "a.gpq", tmp_path / "a.geojson"
    t_write(p_sp, columns=cols, sort="hilbert", device="cpu")
    with tgq.GeoParquetLikeWriter(p_gq) as w:
        w.write_geometries(geoms)
    tgj.write_geojson(p_gj, geoms)
    s_sp, s_gq, s_gj = (p.stat().st_size for p in (p_sp, p_gq, p_gj))
    assert s_sp < s_gq < s_gj, (s_sp, s_gq, s_gj)
    assert s_sp < 0.6 * s_gq
