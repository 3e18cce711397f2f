"""Dremel-style shredding of geometries into Spatial Parquet columns (paper §2).

Physical columns: ``type`` (one per sub-geometry, RLE), ``x``/``y`` (one per
coordinate, FP-delta), plus 2-bit repetition and definition level streams.

Level semantics (one *slot* per coordinate, plus one per empty sub-geometry):

====  =============================================================
rep   0 = record start, 1 = sub-geometry start (GeometryCollection
      flattening, paper §2.7), 2 = part start, 3 = within part
defn  0 = empty sub-geometry marker (no x/y value), 1 = value present
====  =============================================================

``type_rep`` (one per sub-geometry, values {0,1}) marks record boundaries in
the type column; plain geometries have exactly one sub-geometry. A
single-element GeometryCollection is indistinguishable from its element after
flattening — inherent to the paper's §2.7 scheme.

Two APIs: the object API (:func:`shred` / :func:`assemble`) over
:class:`~repro.core.geometry.Geometry` lists, and the vectorized *ragged* API
(:func:`from_ragged` / :meth:`GeometryColumns.to_ragged`) used by the data
pipeline and generators (no per-record Python loop).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .geometry import (
    TYPE_EMPTY,
    TYPE_GEOMETRYCOLLECTION,
    TYPE_MULTIPOLYGON,
    TYPE_POLYGON,
    Geometry,
    polygons_from_rings,
)


@dataclass
class TorchCoords:
    """A device-resident coordinate column (the ``keep_on_device`` form).

    Holds the decoded IEEE-754 bit patterns as one integer tensor on the
    read's device — int32 for 32-bit coordinates, int64 for 64-bit — the
    exact output of the fused device scan, with **zero host transfer**
    until :meth:`to_numpy` is called.
    """

    bits: torch.Tensor          # (n,) int32 or int64 tensor
    dtype: np.dtype

    def __len__(self) -> int:
        return int(self.bits.shape[0])

    def to_numpy(self) -> np.ndarray:
        """Transfer to host and bitcast to the coordinate dtype."""
        return self.bits.cpu().numpy().view(self.dtype)

    @staticmethod
    def from_numpy(arr: np.ndarray, device) -> "TorchCoords":
        """Upload a host coordinate array's bit patterns to ``device``
        (inverse of :meth:`to_numpy`; used when a host-decoded chunk joins a
        device-resident result)."""
        arr = np.ascontiguousarray(arr)
        ibits = arr.view(np.int32 if arr.dtype.itemsize == 4 else np.int64)
        return TorchCoords(torch.from_numpy(ibits.copy()).to(device), arr.dtype)

    @staticmethod
    def concat(parts: list["TorchCoords"]) -> "TorchCoords":
        """Device-side concatenation (no host round-trip)."""
        if len(parts) == 1:
            return parts[0]
        return TorchCoords(torch.cat([p.bits for p in parts]), parts[0].dtype)


@dataclass
class GeometryColumns:
    """The shredded (columnar) form of a geometry column chunk.

    ``x``/``y`` are host numpy arrays on every default path; the fused
    device scan (``read_columnar(..., keep_on_device=True)``) returns them
    as :class:`TorchCoords` instead — structural methods (record counts,
    level slicing) keep working, value-level APIs need
    :meth:`coords_to_host` first.
    """

    types: np.ndarray      # uint8, one per sub-geometry
    type_rep: np.ndarray   # uint8 {0,1}, one per sub-geometry
    rep: np.ndarray        # uint8 {0..3}, one per slot
    defn: np.ndarray       # uint8 {0,1}, one per slot
    x: np.ndarray          # float64/float32, one per value slot (defn==1)
    y: np.ndarray

    def coords_to_host(self) -> "GeometryColumns":
        """Materialize device-resident coordinates (no-op for host arrays)."""
        if not isinstance(self.x, TorchCoords):
            return self
        return GeometryColumns(self.types, self.type_rep, self.rep, self.defn,
                               self.x.to_numpy(), self.y.to_numpy())

    @property
    def n_records(self) -> int:
        return int(np.count_nonzero(self.rep == 0))

    @property
    def n_values(self) -> int:
        return len(self.x)

    @property
    def n_slots(self) -> int:
        return len(self.rep)

    def record_value_starts(self) -> np.ndarray:
        """Index into x/y of the first value of each record (records with at
        least one coordinate; empty records contribute their successor's)."""
        starts_slots = np.flatnonzero(self.rep == 0)
        value_idx = np.cumsum(self.defn.astype(np.int64)) - self.defn
        return value_idx[starts_slots]

    def slice_records(self, start: int, stop: int) -> "GeometryColumns":
        """Record-aligned slice (used by the page writer)."""
        rec_slot_starts = np.flatnonzero(self.rep == 0)
        rec_type_starts = np.flatnonzero(self.type_rep == 0)
        n = len(rec_slot_starts)
        s0 = rec_slot_starts[start] if start < n else self.n_slots
        s1 = rec_slot_starts[stop] if stop < n else self.n_slots
        t0 = rec_type_starts[start] if start < n else len(self.types)
        t1 = rec_type_starts[stop] if stop < n else len(self.types)
        vstart = int(np.count_nonzero(self.defn[:s0]))
        vstop = int(np.count_nonzero(self.defn[:s1]))
        return GeometryColumns(
            self.types[t0:t1],
            self.type_rep[t0:t1],
            self.rep[s0:s1],
            self.defn[s0:s1],
            self.x[vstart:vstop],
            self.y[vstart:vstop],
        )

    def to_ragged(self):
        """Vectorized inverse of :func:`from_ragged`.

        Returns ``(types, coords(n,2), part_sizes, parts_per_subgeom,
        subgeoms_per_record)`` — empty sub-geometries appear with 0 parts.
        """
        value_mask = self.defn == 1
        coords = np.stack([self.x, self.y], axis=1)
        # part starts among value slots (record/sub-geom starts are also <= 2)
        vrep = self.rep[value_mask]
        part_starts = np.flatnonzero(vrep <= 2)
        part_sizes = np.diff(np.concatenate([part_starts, [len(vrep)]]))
        # parts per sub-geometry: count part starts between sub-geom starts
        sub_start_mask = self.rep <= 1
        subgeom_is_empty = (self.defn == 0)[sub_start_mask]
        vsub_starts = np.flatnonzero(vrep <= 1)
        bounds = np.concatenate([vsub_starts, [len(vrep)]])
        parts_per_nonempty = np.diff(np.searchsorted(part_starts, bounds))
        parts_per_subgeom = np.zeros(len(subgeom_is_empty), dtype=np.int64)
        parts_per_subgeom[~subgeom_is_empty] = parts_per_nonempty
        # sub-geometries per record
        sub_rep = self.rep[sub_start_mask]
        rec_start_idx = np.flatnonzero(sub_rep == 0)
        subgeoms_per_record = np.diff(np.concatenate([rec_start_idx, [len(sub_rep)]]))
        return self.types, coords, part_sizes, parts_per_subgeom, subgeoms_per_record


def compact_levels(types, type_rep, rep, defn, keep):
    """The four level streams of the records ``keep`` (one bool a record)
    marks: each slot and sub-geometry follows the record it belongs to.
    Equal to ``permute_records`` on the kept records in order, so canonical
    levels stay canonical."""
    slot_keep = keep[np.cumsum(rep == 0) - 1]
    type_keep = keep[np.cumsum(type_rep == 0) - 1]
    return types[type_keep], type_rep[type_keep], rep[slot_keep], defn[slot_keep]


def from_ragged(
    types: np.ndarray,
    coords: np.ndarray,
    part_sizes: np.ndarray,
    parts_per_subgeom: np.ndarray,
    subgeoms_per_record: np.ndarray | None = None,
) -> GeometryColumns:
    """Vectorized shredding from ragged arrays (no per-record loop).

    ``types``: uint8 per sub-geometry; ``coords``: (n,2); ``part_sizes``:
    coords per part; ``parts_per_subgeom``: parts per sub-geometry (0 =>
    empty); ``subgeoms_per_record``: default all-ones (no collections).
    """
    types = np.ascontiguousarray(types, dtype=np.uint8)
    part_sizes = np.ascontiguousarray(part_sizes, dtype=np.int64)
    parts_per_subgeom = np.ascontiguousarray(parts_per_subgeom, dtype=np.int64)
    n_sub = len(types)
    if subgeoms_per_record is None:
        subgeoms_per_record = np.ones(n_sub, dtype=np.int64)
    subgeoms_per_record = np.ascontiguousarray(subgeoms_per_record, dtype=np.int64)
    if (part_sizes <= 0).any():
        raise ValueError("part_sizes must be positive (empty parts not stored)")
    if int(parts_per_subgeom.sum()) != len(part_sizes):
        raise ValueError("parts_per_subgeom does not sum to len(part_sizes)")
    if int(subgeoms_per_record.sum()) != n_sub:
        raise ValueError("subgeoms_per_record does not sum to len(types)")

    n_values = int(part_sizes.sum())
    # coords per sub-geometry via segment sums of part_sizes
    nonempty = parts_per_subgeom > 0
    csum = np.concatenate([[0], np.cumsum(part_sizes)])
    ends = np.cumsum(parts_per_subgeom)
    starts = ends - parts_per_subgeom
    coords_per_subgeom = csum[ends] - csum[starts]
    # slots per sub-geometry: #coords, or 1 for empty markers
    slots_per_subgeom = np.where(nonempty, coords_per_subgeom, 1)
    n_slots = int(slots_per_subgeom.sum())

    rep = np.full(n_slots, 3, dtype=np.uint8)
    defn = np.ones(n_slots, dtype=np.uint8)
    sub_slot_starts = np.cumsum(slots_per_subgeom) - slots_per_subgeom
    # part starts: slot offset of the owning sub-geometry + local coord offset
    if len(part_sizes):
        part_sub = np.repeat(np.arange(n_sub), parts_per_subgeom)
        excl = csum[:-1]  # exclusive coord offset of each part
        first_part_of_sub = starts  # per sub-geometry
        local_within_sub = excl - excl[first_part_of_sub[part_sub]]
        part_slot = sub_slot_starts[part_sub] + local_within_sub
        rep[part_slot] = 2
    # sub-geometry starts
    rep[sub_slot_starts] = 1
    defn[sub_slot_starts[~nonempty]] = 0
    # record starts
    rec_first_sub = np.cumsum(subgeoms_per_record) - subgeoms_per_record
    rep[sub_slot_starts[rec_first_sub]] = 0

    type_rep = np.ones(n_sub, dtype=np.uint8)
    type_rep[rec_first_sub] = 0

    coords = np.asarray(coords)
    if coords.shape != (n_values, 2):
        raise ValueError(f"coords shape {coords.shape} != ({n_values}, 2)")
    return GeometryColumns(
        types, type_rep, rep, defn,
        np.ascontiguousarray(coords[:, 0]), np.ascontiguousarray(coords[:, 1]),
    )


def shred(geometries) -> GeometryColumns:
    """Object-API shredding of a sequence of :class:`Geometry`."""
    types: list[int] = []
    part_sizes: list[int] = []
    parts_per_sub: list[int] = []
    subs_per_record: list[int] = []
    coord_arrays: list[np.ndarray] = []
    for g in geometries:
        subs = g.sub_geometries if g.geom_type == TYPE_GEOMETRYCOLLECTION else [g]
        if not subs:  # empty collection degenerates to empty geometry
            subs = [Geometry.empty()]
        subs_per_record.append(len(subs))
        for sub in subs:
            pts = sum(len(p) for p in sub.parts)
            if pts == 0:
                types.append(TYPE_EMPTY)
                parts_per_sub.append(0)
            else:
                types.append(sub.geom_type)
                parts_per_sub.append(len(sub.parts))
                for p in sub.parts:
                    part_sizes.append(len(p))
                    coord_arrays.append(np.asarray(p, dtype=np.float64))
    coords = (
        np.concatenate(coord_arrays, axis=0)
        if coord_arrays
        else np.zeros((0, 2), dtype=np.float64)
    )
    return from_ragged(
        np.array(types, dtype=np.uint8),
        coords,
        np.array(part_sizes, dtype=np.int64),
        np.array(parts_per_sub, dtype=np.int64),
        np.array(subs_per_record, dtype=np.int64),
    )


def assemble(cols: GeometryColumns) -> list[Geometry]:
    """Reconstruct Geometry objects (paper §2 read path, incl. §2.6 winding)."""
    types, coords, part_sizes, parts_per_sub, subs_per_rec = cols.to_ragged()
    part_bounds = np.cumsum(part_sizes)
    parts = np.split(coords, part_bounds[:-1]) if len(part_sizes) else []
    out: list[Geometry] = []
    pi = 0  # part cursor
    si = 0  # sub-geometry cursor
    for n_subs in subs_per_rec:
        subs: list[Geometry] = []
        for _ in range(int(n_subs)):
            t = int(types[si])
            n_parts = int(parts_per_sub[si])
            gparts = parts[pi : pi + n_parts]
            pi += n_parts
            si += 1
            if t == TYPE_EMPTY or n_parts == 0:
                subs.append(Geometry.empty())
            elif t == TYPE_MULTIPOLYGON:
                # regroup rings into sub-polygons via winding (paper §2.6)
                subs.append(Geometry(t, [r for r in gparts]))
            else:
                subs.append(Geometry(t, gparts))
        out.append(subs[0] if n_subs == 1 else Geometry(TYPE_GEOMETRYCOLLECTION, [], subs))
    return out


def multipolygon_polygons(g: Geometry) -> list[list[np.ndarray]]:
    """Decompose a (Multi)Polygon's flat ring list into per-polygon ring lists."""
    if g.geom_type not in (TYPE_POLYGON, TYPE_MULTIPOLYGON):
        raise ValueError("not a polygonal geometry")
    if g.geom_type == TYPE_POLYGON:
        return [g.parts]
    return polygons_from_rings(g.parts)
