"""GeoJSON (RFC 7946) baseline — the row-oriented text format of Table 2/3.

Uses orjson (fast C JSON) when available to be fair on write/read time,
falling back to the stdlib ``json`` module otherwise (same bytes modulo
float formatting; benchmark numbers then flatter Spatial Parquet, so treat
them as an upper bound). Compression is whole-file gzip exactly as the paper
applies it ("the entire dataset is written as one giant .geojson.gz file").
"""

from __future__ import annotations

import gzip

import numpy as np

try:
    import orjson
except ImportError:  # pragma: no cover - orjson is an optional speedup
    import json as _json

    class orjson:  # type: ignore[no-redef]
        """Minimal stdlib shim for the two orjson entry points we use."""

        @staticmethod
        def dumps(obj) -> bytes:
            return _json.dumps(obj, separators=(",", ":")).encode()

        @staticmethod
        def loads(blob):
            if isinstance(blob, (bytes, bytearray, memoryview)):
                blob = bytes(blob).decode()
            return _json.loads(blob)

from repro_torch.core.columnar import assemble, multipolygon_polygons, shred
from repro_torch.core.geometry import (
    TYPE_GEOMETRYCOLLECTION,
    TYPE_LINESTRING,
    TYPE_MULTILINESTRING,
    TYPE_MULTIPOINT,
    TYPE_MULTIPOLYGON,
    TYPE_POINT,
    TYPE_POLYGON,
    Geometry,
)

_NAMES = {
    TYPE_POINT: "Point",
    TYPE_LINESTRING: "LineString",
    TYPE_POLYGON: "Polygon",
    TYPE_MULTIPOINT: "MultiPoint",
    TYPE_MULTILINESTRING: "MultiLineString",
    TYPE_MULTIPOLYGON: "MultiPolygon",
}


def geometry_to_json_obj(g: Geometry) -> dict:
    t = g.geom_type
    if t == TYPE_POINT:
        return {"type": "Point", "coordinates": g.parts[0][0].tolist()}
    if t == TYPE_LINESTRING:
        return {"type": "LineString", "coordinates": g.parts[0].tolist()}
    if t == TYPE_POLYGON:
        return {"type": "Polygon", "coordinates": [r.tolist() for r in g.parts]}
    if t == TYPE_MULTIPOINT:
        return {"type": "MultiPoint", "coordinates": [p[0].tolist() for p in g.parts]}
    if t == TYPE_MULTILINESTRING:
        return {"type": "MultiLineString", "coordinates": [l.tolist() for l in g.parts]}
    if t == TYPE_MULTIPOLYGON:
        return {
            "type": "MultiPolygon",
            "coordinates": [[r.tolist() for r in rings] for rings in multipolygon_polygons(g)],
        }
    if t == TYPE_GEOMETRYCOLLECTION:
        return {"type": "GeometryCollection",
                "geometries": [geometry_to_json_obj(s) for s in g.sub_geometries]}
    return {"type": "GeometryCollection", "geometries": []}


def json_obj_to_geometry(o: dict) -> Geometry:
    t = o["type"]
    c = o.get("coordinates")
    if t == "Point":
        return Geometry.point(c[0], c[1])
    if t == "LineString":
        return Geometry.linestring(c)
    if t == "Polygon":
        return Geometry(TYPE_POLYGON, [np.asarray(r, np.float64) for r in c])
    if t == "MultiPoint":
        return Geometry(TYPE_MULTIPOINT, [np.asarray([p], np.float64) for p in c])
    if t == "MultiLineString":
        return Geometry(TYPE_MULTILINESTRING, [np.asarray(l, np.float64) for l in c])
    if t == "MultiPolygon":
        parts = [np.asarray(r, np.float64) for rings in c for r in rings]
        return Geometry(TYPE_MULTIPOLYGON, parts)
    if t == "GeometryCollection":
        return Geometry(TYPE_GEOMETRYCOLLECTION, [],
                        [json_obj_to_geometry(s) for s in o["geometries"]])
    raise ValueError(f"unknown GeoJSON type {t}")


def write_geojson(path, geoms: list[Geometry], *, gz: bool = False) -> None:
    features = [
        {"type": "Feature", "properties": {}, "geometry": geometry_to_json_obj(g)}
        for g in geoms
    ]
    blob = orjson.dumps({"type": "FeatureCollection", "features": features})
    if gz:
        blob = gzip.compress(blob, 6)
    with open(path, "wb") as fh:
        fh.write(blob)


def read_geojson(path, *, gz: bool = False) -> list[Geometry]:
    blob = open(path, "rb").read()
    if gz:
        blob = gzip.decompress(blob)
    obj = orjson.loads(blob)
    return [json_obj_to_geometry(f["geometry"]) for f in obj["features"]]


def write_geojson_columns(path, cols, **kw) -> None:
    write_geojson(path, assemble(cols), **kw)
