"""Well-Known Binary (ISO 13249-3 / OGC SFA) encode/decode.

Used by the GeoParquet-like and Shapefile baselines and their benchmarks.
Little-endian, 2-D geometries, vectorized per-geometry bodies.
"""

from __future__ import annotations

import struct

import numpy as np

from repro_torch.core.columnar import multipolygon_polygons
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

_LE = 1


def _coords_bytes(arr: np.ndarray) -> bytes:
    return np.ascontiguousarray(arr, dtype="<f8").tobytes()


def geometry_to_wkb(g: Geometry) -> bytes:
    t = g.geom_type
    if t == TYPE_POINT:
        return struct.pack("<bI", _LE, 1) + _coords_bytes(g.parts[0][0])
    if t == TYPE_LINESTRING:
        pts = g.parts[0]
        return struct.pack("<bII", _LE, 2, len(pts)) + _coords_bytes(pts)
    if t == TYPE_POLYGON:
        out = [struct.pack("<bII", _LE, 3, len(g.parts))]
        for ring in g.parts:
            out.append(struct.pack("<I", len(ring)) + _coords_bytes(ring))
        return b"".join(out)
    if t == TYPE_MULTIPOINT:
        out = [struct.pack("<bII", _LE, 4, len(g.parts))]
        for p in g.parts:
            out.append(struct.pack("<bI", _LE, 1) + _coords_bytes(p[0]))
        return b"".join(out)
    if t == TYPE_MULTILINESTRING:
        out = [struct.pack("<bII", _LE, 5, len(g.parts))]
        for line in g.parts:
            out.append(struct.pack("<bII", _LE, 2, len(line)) + _coords_bytes(line))
        return b"".join(out)
    if t == TYPE_MULTIPOLYGON:
        polys = multipolygon_polygons(g)
        out = [struct.pack("<bII", _LE, 6, len(polys))]
        for rings in polys:
            out.append(struct.pack("<bII", _LE, 3, len(rings)))
            for ring in rings:
                out.append(struct.pack("<I", len(ring)) + _coords_bytes(ring))
        return b"".join(out)
    if t == TYPE_GEOMETRYCOLLECTION:
        out = [struct.pack("<bII", _LE, 7, len(g.sub_geometries))]
        for sub in g.sub_geometries:
            out.append(geometry_to_wkb(sub))
        return b"".join(out)
    # empty geometry: encode as empty collection
    return struct.pack("<bII", _LE, 7, 0)


def wkb_to_geometry(buf: bytes, offset: int = 0) -> tuple[Geometry, int]:
    bo, t = struct.unpack_from("<bI", buf, offset)
    offset += 5

    def rd_pts(n, off):
        arr = np.frombuffer(buf, "<f8", n * 2, off).reshape(n, 2).copy()
        return arr, off + 16 * n

    if t == 1:
        pts, offset = rd_pts(1, offset)
        return Geometry(TYPE_POINT, [pts]), offset
    if t == 2:
        (n,) = struct.unpack_from("<I", buf, offset)
        pts, offset = rd_pts(n, offset + 4)
        return Geometry(TYPE_LINESTRING, [pts]), offset
    if t == 3:
        (nr,) = struct.unpack_from("<I", buf, offset)
        offset += 4
        rings = []
        for _ in range(nr):
            (n,) = struct.unpack_from("<I", buf, offset)
            ring, offset = rd_pts(n, offset + 4)
            rings.append(ring)
        return Geometry(TYPE_POLYGON, rings), offset
    if t in (4, 5, 6):
        (k,) = struct.unpack_from("<I", buf, offset)
        offset += 4
        parts: list[np.ndarray] = []
        for _ in range(k):
            sub, offset = wkb_to_geometry(buf, offset)
            parts.extend(sub.parts)
        return Geometry({4: TYPE_MULTIPOINT, 5: TYPE_MULTILINESTRING, 6: TYPE_MULTIPOLYGON}[t], parts), offset
    if t == 7:
        (k,) = struct.unpack_from("<I", buf, offset)
        offset += 4
        subs = []
        for _ in range(k):
            sub, offset = wkb_to_geometry(buf, offset)
            subs.append(sub)
        if not subs:
            return Geometry.empty(), offset
        return Geometry(TYPE_GEOMETRYCOLLECTION, [], subs), offset
    raise ValueError(f"unsupported WKB type {t}")
