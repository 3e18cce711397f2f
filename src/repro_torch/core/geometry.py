"""OGC geometry model for Spatial Parquet (paper §2, Appendix A.1).

Geometries are held as ``(geom_type, parts)`` where ``parts`` is a list of
``(k, 2)`` float arrays. This mirrors the paper's unified PBF schema::

    message Geometry {
      required int type;
      repeated group part { repeated group coordinate { x; y; } }
    }

Winding conventions (paper §2.3/§2.6): polygon outer shells are stored
clockwise (CW), holes counter-clockwise (CCW); MultiPolygon sub-polygon
boundaries are recovered from the winding test on read.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

TYPE_EMPTY = 0
TYPE_POINT = 1
TYPE_LINESTRING = 2
TYPE_POLYGON = 3
TYPE_MULTIPOINT = 4
TYPE_MULTILINESTRING = 5
TYPE_MULTIPOLYGON = 6
TYPE_GEOMETRYCOLLECTION = 7  # flattened on write (paper §2.7)

TYPE_NAMES = {
    TYPE_EMPTY: "Empty",
    TYPE_POINT: "Point",
    TYPE_LINESTRING: "LineString",
    TYPE_POLYGON: "Polygon",
    TYPE_MULTIPOINT: "MultiPoint",
    TYPE_MULTILINESTRING: "MultiLineString",
    TYPE_MULTIPOLYGON: "MultiPolygon",
    TYPE_GEOMETRYCOLLECTION: "GeometryCollection",
}


def signed_area(ring: np.ndarray) -> float:
    """Shoelace signed area; positive for CCW rings (math convention)."""
    x, y = ring[:, 0], ring[:, 1]
    return 0.5 * float(np.dot(x, np.roll(y, -1)) - np.dot(np.roll(x, -1), y))


def is_cw(ring: np.ndarray) -> bool:
    return signed_area(ring) <= 0.0


def close_ring(ring: np.ndarray) -> np.ndarray:
    """Repeat the first point at the end if not already closed (paper §2.3)."""
    if len(ring) and not np.array_equal(ring[0], ring[-1]):
        return np.vstack([ring, ring[:1]])
    return ring


def orient_ring(ring: np.ndarray, clockwise: bool) -> np.ndarray:
    return ring if is_cw(ring) == clockwise else ring[::-1].copy()


@dataclass
class Geometry:
    """A single geometry: type code + list of parts ((k,2) arrays)."""

    geom_type: int
    parts: list[np.ndarray] = field(default_factory=list)
    # Only for GeometryCollection: flattened sub-geometries.
    sub_geometries: list["Geometry"] = field(default_factory=list)

    # ------------------------------------------------------------------ ctor
    @staticmethod
    def point(x: float, y: float) -> "Geometry":
        return Geometry(TYPE_POINT, [np.array([[x, y]], dtype=np.float64)])

    @staticmethod
    def linestring(coords) -> "Geometry":
        return Geometry(TYPE_LINESTRING, [np.asarray(coords, dtype=np.float64)])

    @staticmethod
    def polygon(shell, holes=()) -> "Geometry":
        """Shell stored CW, holes CCW, rings closed (paper conventions)."""
        parts = [orient_ring(close_ring(np.asarray(shell, np.float64)), clockwise=True)]
        for h in holes:
            parts.append(orient_ring(close_ring(np.asarray(h, np.float64)), clockwise=False))
        return Geometry(TYPE_POLYGON, parts)

    @staticmethod
    def multipoint(coords) -> "Geometry":
        pts = np.asarray(coords, dtype=np.float64)
        # one part per point — semantically accurate per paper §2.4
        return Geometry(TYPE_MULTIPOINT, [pts[i : i + 1] for i in range(len(pts))])

    @staticmethod
    def multilinestring(lines) -> "Geometry":
        return Geometry(TYPE_MULTILINESTRING, [np.asarray(l, np.float64) for l in lines])

    @staticmethod
    def multipolygon(polygons) -> "Geometry":
        """``polygons`` is a list of (shell, holes) pairs or Polygon Geometries."""
        parts: list[np.ndarray] = []
        for poly in polygons:
            if isinstance(poly, Geometry):
                parts.extend(poly.parts)
            else:
                shell, holes = poly if isinstance(poly, tuple) else (poly, ())
                parts.append(orient_ring(close_ring(np.asarray(shell, np.float64)), True))
                for h in holes:
                    parts.append(orient_ring(close_ring(np.asarray(h, np.float64)), False))
        return Geometry(TYPE_MULTIPOLYGON, parts)

    @staticmethod
    def collection(geoms) -> "Geometry":
        """GeometryCollection; nested collections are flattened (paper §2.7)."""
        flat: list[Geometry] = []

        def _flatten(g: "Geometry"):
            if g.geom_type == TYPE_GEOMETRYCOLLECTION:
                for sub in g.sub_geometries:
                    _flatten(sub)
            else:
                flat.append(g)

        for g in geoms:
            _flatten(g)
        if len(flat) == 1:
            # canonicalize: a single-element collection is indistinguishable
            # from its element after §2.7 flattening (see columnar.py)
            return flat[0]
        return Geometry(TYPE_GEOMETRYCOLLECTION, [], flat)

    @staticmethod
    def empty() -> "Geometry":
        return Geometry(TYPE_EMPTY, [])

    # ----------------------------------------------------------------- props
    @property
    def num_points(self) -> int:
        if self.geom_type == TYPE_GEOMETRYCOLLECTION:
            return sum(g.num_points for g in self.sub_geometries)
        return sum(len(p) for p in self.parts)

    def bbox(self) -> tuple[float, float, float, float]:
        """(xmin, ymin, xmax, ymax); inverted-empty box for empty geometries."""
        arrays = (
            [p for g in self.sub_geometries for p in g.parts]
            if self.geom_type == TYPE_GEOMETRYCOLLECTION
            else self.parts
        )
        if not arrays or not sum(len(a) for a in arrays):
            return (np.inf, np.inf, -np.inf, -np.inf)
        allc = np.vstack(arrays)
        return (
            float(allc[:, 0].min()),
            float(allc[:, 1].min()),
            float(allc[:, 0].max()),
            float(allc[:, 1].max()),
        )

    def centroid(self) -> tuple[float, float]:
        b = self.bbox()
        return ((b[0] + b[2]) / 2.0, (b[1] + b[3]) / 2.0)

    # --------------------------------------------------------------- dunders
    def __eq__(self, other) -> bool:
        if not isinstance(other, Geometry):
            return NotImplemented
        if self.geom_type != other.geom_type:
            return False
        if self.geom_type == TYPE_GEOMETRYCOLLECTION:
            return self.sub_geometries == other.sub_geometries
        if len(self.parts) != len(other.parts):
            return False
        return all(
            a.shape == b.shape and np.array_equal(a.view(np.int64), b.view(np.int64))
            for a, b in zip(self.parts, other.parts)
        )

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<{TYPE_NAMES[self.geom_type]} parts={len(self.parts)} pts={self.num_points}>"


def polygons_from_rings(rings: list[np.ndarray]) -> list[list[np.ndarray]]:
    """Group a flat ring list into polygons via the winding test (paper §2.6).

    CW ring => new outer shell; CCW ring => hole of the current polygon. The
    first ring is always a shell regardless of winding (defensive).
    """
    polygons: list[list[np.ndarray]] = []
    for i, ring in enumerate(rings):
        if i == 0 or is_cw(ring):
            polygons.append([ring])
        else:
            polygons[-1].append(ring)
    return polygons


def bbox_intersects(a, b) -> bool:
    return not (a[2] < b[0] or b[2] < a[0] or a[3] < b[1] or b[3] < a[1])
