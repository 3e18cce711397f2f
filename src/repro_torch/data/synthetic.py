"""Synthetic analogs of the paper's four evaluation datasets (Table 1).

The real datasets (Porto Taxi, TIGER roads, MSBuildings, eBird) live on
UCR-Star and are not downloadable offline; these generators match their
*structure* (geometry type, clustering, point counts per geometry, GPS-like
coordinate precision) at configurable scale. All generators emit the ragged
fast path (:func:`repro_torch.core.columnar.from_ragged`) — no per-record loops.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.columnar import GeometryColumns, from_ragged
from repro_torch.core.geometry import (
    TYPE_MULTILINESTRING,
    TYPE_MULTIPOINT,
    TYPE_POINT,
    TYPE_POLYGON,
)

# Porto-ish / continental bounding boxes for realism
PORTO_BBOX = (-8.70, 41.10, -8.50, 41.25)
US_BBOX = (-124.0, 25.0, -67.0, 49.0)


def _round_gps(a: np.ndarray, decimals: int = 6) -> np.ndarray:
    return np.round(a, decimals)


def porto_taxi_like(n_traj: int = 20_000, mean_pts: int = 48, seed: int = 0) -> GeometryColumns:
    """MultiPoint trajectories: random-walk GPS traces inside Porto (PT)."""
    rng = np.random.default_rng(seed)
    npts = rng.poisson(mean_pts, n_traj).clip(2, 4 * mean_pts)
    total = int(npts.sum())
    x0 = rng.uniform(PORTO_BBOX[0], PORTO_BBOX[2], n_traj)
    y0 = rng.uniform(PORTO_BBOX[1], PORTO_BBOX[3], n_traj)
    # ~15 m GPS steps at ~1e-4 degrees
    steps = rng.normal(0, 1.5e-4, (total, 2))
    traj_id = np.repeat(np.arange(n_traj), npts)
    first = np.concatenate([[0], np.cumsum(npts)[:-1]])
    steps[first] = 0.0
    walk = np.cumsum(steps, axis=0)
    walk -= np.repeat(walk[first], npts, axis=0)
    coords = np.stack([x0[traj_id], y0[traj_id]], 1) + walk
    coords = _round_gps(coords)
    # MultiPoint: one part per point (paper §2.4)
    return from_ragged(
        np.full(n_traj, TYPE_MULTIPOINT, np.uint8),
        coords,
        np.ones(total, np.int64),
        npts.astype(np.int64),
    )


def roads_like(n_roads: int = 50_000, mean_pts: int = 18, seed: int = 1) -> GeometryColumns:
    """MultiLineString road segments across a US-like extent (TR)."""
    rng = np.random.default_rng(seed)
    lines_per = rng.integers(1, 4, n_roads)
    n_lines = int(lines_per.sum())
    pts_per_line = rng.poisson(mean_pts, n_lines).clip(2, 4 * mean_pts)
    total = int(pts_per_line.sum())
    # cluster roads around towns
    towns = np.stack(
        [rng.uniform(US_BBOX[0], US_BBOX[2], 400), rng.uniform(US_BBOX[1], US_BBOX[3], 400)], 1
    )
    line_town = rng.integers(0, len(towns), n_lines)
    start = towns[line_town] + rng.normal(0, 0.05, (n_lines, 2))
    heading = rng.uniform(0, 2 * np.pi, n_lines)
    step = 2e-4  # ~20 m
    line_id = np.repeat(np.arange(n_lines), pts_per_line)
    t = np.concatenate([np.arange(k) for k in pts_per_line])
    wiggle = rng.normal(0, 3e-5, (total, 2))
    coords = start[line_id] + np.stack(
        [np.cos(heading[line_id]) * t * step, np.sin(heading[line_id]) * t * step], 1
    ) + wiggle
    coords = _round_gps(coords)
    return from_ragged(
        np.full(n_roads, TYPE_MULTILINESTRING, np.uint8),
        coords,
        pts_per_line.astype(np.int64),
        lines_per.astype(np.int64),
    )


def buildings_like(n_buildings: int = 100_000, seed: int = 2) -> GeometryColumns:
    """Polygon building footprints: small axis-ish rectangles w/ jitter (MB)."""
    rng = np.random.default_rng(seed)
    towns = np.stack(
        [rng.uniform(US_BBOX[0], US_BBOX[2], 800), rng.uniform(US_BBOX[1], US_BBOX[3], 800)], 1
    )
    center = towns[rng.integers(0, len(towns), n_buildings)] + rng.normal(0, 0.02, (n_buildings, 2))
    w = rng.uniform(5e-5, 3e-4, n_buildings)   # ~5-30 m
    h = rng.uniform(5e-5, 3e-4, n_buildings)
    # 5-point closed CW rings with vertex jitter
    dx = np.stack([-w, w, w, -w, -w], 1) / 2
    dy = np.stack([h, h, -h, -h, h], 1) / 2   # CW order
    xs = center[:, :1] + dx + rng.normal(0, 5e-6, (n_buildings, 5))
    ys = center[:, 1:] + dy + rng.normal(0, 5e-6, (n_buildings, 5))
    xs[:, 4] = xs[:, 0]
    ys[:, 4] = ys[:, 0]
    coords = _round_gps(np.stack([xs.reshape(-1), ys.reshape(-1)], 1))
    return from_ragged(
        np.full(n_buildings, TYPE_POLYGON, np.uint8),
        coords,
        np.full(n_buildings, 5, np.int64),
        np.ones(n_buildings, np.int64),
    )


def ebird_like(n_points: int = 500_000, seed: int = 3, shuffled: bool = True) -> GeometryColumns:
    """Point observations: heavy hotspot clustering, unsorted from source (eB).

    The paper notes eBird is NOT pre-sorted — alternating-sign coordinates
    produce the 64-bit delta spike of Figure 8a. ``shuffled=True`` reproduces
    that; sorting (writer ``sort='hilbert'``) collapses it.
    """
    rng = np.random.default_rng(seed)
    n_hot = 2000
    hots = np.stack(
        [rng.uniform(US_BBOX[0], US_BBOX[2], n_hot), rng.uniform(US_BBOX[1], US_BBOX[3], n_hot)], 1
    )
    weights = rng.pareto(1.2, n_hot) + 1
    weights /= weights.sum()
    hid = rng.choice(n_hot, n_points, p=weights)
    coords = hots[hid] + rng.normal(0, 0.01, (n_points, 2))
    coords = _round_gps(coords)
    if shuffled:
        coords = coords[rng.permutation(n_points)]
    return from_ragged(
        np.full(n_points, TYPE_POINT, np.uint8),
        coords,
        np.ones(n_points, np.int64),
        np.ones(n_points, np.int64),
    )


DATASETS = {
    "PT": porto_taxi_like,
    "TR": roads_like,
    "MB": buildings_like,
    "eB": ebird_like,
}
