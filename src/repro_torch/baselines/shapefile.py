"""Minimal ESRI Shapefile (.shp) writer/reader — the third paper baseline.

Implements the 1998 ESRI whitepaper main-file layout for the shape types the
evaluation datasets use: Point(1), PolyLine(3), Polygon(5), MultiPoint(8).
Like the paper's setup, data is partitioned into <=1M-record .shp parts and
compression (gzip) is applied per part file.

(No .shx/.dbf sidecars: the paper strips attributes and compares pure
geometry storage; the .shp main file is where geometry bytes live.)
"""

from __future__ import annotations

import struct

import numpy as np

from repro_torch.core.columnar import multipolygon_polygons
from repro_torch.core.geometry import (
    TYPE_LINESTRING,
    TYPE_MULTILINESTRING,
    TYPE_MULTIPOINT,
    TYPE_MULTIPOLYGON,
    TYPE_POINT,
    TYPE_POLYGON,
    Geometry,
)

SHP_POINT, SHP_POLYLINE, SHP_POLYGON, SHP_MULTIPOINT = 1, 3, 5, 8

_TO_SHP = {
    TYPE_POINT: SHP_POINT,
    TYPE_LINESTRING: SHP_POLYLINE,
    TYPE_MULTILINESTRING: SHP_POLYLINE,
    TYPE_POLYGON: SHP_POLYGON,
    TYPE_MULTIPOLYGON: SHP_POLYGON,
    TYPE_MULTIPOINT: SHP_MULTIPOINT,
}


def _record_body(g: Geometry) -> bytes:
    st = _TO_SHP[g.geom_type]
    if st == SHP_POINT:
        x, y = g.parts[0][0]
        return struct.pack("<idd", SHP_POINT, x, y)
    if st == SHP_MULTIPOINT:
        pts = np.vstack(g.parts)
        xmin, ymin = pts.min(0)
        xmax, ymax = pts.max(0)
        return (
            struct.pack("<i4di", SHP_MULTIPOINT, xmin, ymin, xmax, ymax, len(pts))
            + pts.astype("<f8").tobytes()
        )
    # PolyLine / Polygon: parts + points
    if g.geom_type == TYPE_MULTIPOLYGON:
        rings = [r for poly in multipolygon_polygons(g) for r in poly]
    else:
        rings = g.parts
    pts = np.vstack(rings)
    sizes = np.array([len(r) for r in rings], np.int64)
    part_offsets = (np.cumsum(sizes) - sizes).astype("<i4")
    xmin, ymin = pts.min(0)
    xmax, ymax = pts.max(0)
    return (
        struct.pack("<i4dii", st, xmin, ymin, xmax, ymax, len(rings), len(pts))
        + part_offsets.tobytes()
        + pts.astype("<f8").tobytes()
    )


def write_shapefile(path, geoms: list[Geometry]) -> None:
    records = []
    total = 100  # header bytes
    for i, g in enumerate(geoms):
        body = _record_body(g)
        records.append(struct.pack(">ii", i + 1, len(body) // 2) + body)
        total += len(records[-1])
    boxes = np.array([g.bbox() for g in geoms], np.float64) if geoms else np.zeros((1, 4))
    header = struct.pack(
        ">i5ii", 9994, 0, 0, 0, 0, 0, total // 2
    ) + struct.pack(
        "<ii4d4d",
        1000, _TO_SHP[geoms[0].geom_type] if geoms else 0,
        float(boxes[:, 0].min()), float(boxes[:, 1].min()),
        float(boxes[:, 2].max()), float(boxes[:, 3].max()),
        0.0, 0.0, 0.0, 0.0,
    )
    with open(path, "wb") as fh:
        fh.write(header)
        for r in records:
            fh.write(r)


def read_shapefile(path) -> list[Geometry]:
    buf = open(path, "rb").read()
    out: list[Geometry] = []
    off = 100
    while off < len(buf):
        _, content_words = struct.unpack_from(">ii", buf, off)
        off += 8
        body = buf[off : off + content_words * 2]
        off += content_words * 2
        (st,) = struct.unpack_from("<i", body, 0)
        if st == SHP_POINT:
            x, y = struct.unpack_from("<dd", body, 4)
            out.append(Geometry.point(x, y))
        elif st == SHP_MULTIPOINT:
            (n,) = struct.unpack_from("<i", body, 36)
            pts = np.frombuffer(body, "<f8", n * 2, 40).reshape(n, 2)
            out.append(Geometry(TYPE_MULTIPOINT, [pts[i : i + 1].copy() for i in range(n)]))
        elif st in (SHP_POLYLINE, SHP_POLYGON):
            nparts, npts = struct.unpack_from("<ii", body, 36)
            offsets = np.frombuffer(body, "<i4", nparts, 44)
            pts = np.frombuffer(body, "<f8", npts * 2, 44 + 4 * nparts).reshape(npts, 2)
            bounds = np.append(offsets, npts)
            parts = [pts[bounds[i] : bounds[i + 1]].copy() for i in range(nparts)]
            t = TYPE_MULTILINESTRING if st == SHP_POLYLINE else TYPE_MULTIPOLYGON
            out.append(Geometry(t, parts))
        else:
            raise ValueError(f"unsupported shape type {st}")
    return out
