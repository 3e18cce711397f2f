"""TIGER/Line roads (the paper's TR table): MultiLineString roads around towns.

A road has 1-3 lines of Poisson(``mean_pts``) points clipped to
2..4 x ``mean_pts``, the parts and points of the repository's ``roads_like``.
Each road draws one of 400 towns uniform over the contiguous US and a start
near it (σ 0.05°); its first line runs from the start, and each later line
starts near the end of the line before it (a jump of σ one step), so the
lines of a road are adjacent, as a TIGER road's are. A road has one heading,
uniform; each line turns from it by σ 0.5 rad. A line runs straight in
2e-4° steps with a 3e-5° wiggle, rounded to 6 decimals.
"""

from __future__ import annotations

import numpy as np

from ..ragged import Ragged

TYPE_MULTILINESTRING = 5      # the format's geometry type code
US_BBOX = (-124.0, 25.0, -67.0, 49.0)
N_TOWNS = 400
STEP = 2e-4                   # degrees between points, about 20 m
MAX_LINES = 3


def generate(sizes: dict, seed: int) -> Ragged:
    n_roads = int(sizes["n_roads"])
    mean_pts = int(sizes.get("mean_pts", 18))
    rng = np.random.default_rng(seed)
    lines_per = rng.integers(1, MAX_LINES + 1, n_roads)
    n_lines = int(lines_per.sum())
    pts_per_line = rng.poisson(mean_pts, n_lines).clip(2, 4 * mean_pts)
    total = int(pts_per_line.sum())
    towns = np.stack([rng.uniform(US_BBOX[0], US_BBOX[2], N_TOWNS),
                      rng.uniform(US_BBOX[1], US_BBOX[3], N_TOWNS)], 1)
    road_start = towns[rng.integers(0, N_TOWNS, n_roads)] + rng.normal(0, 0.05, (n_roads, 2))
    road = np.repeat(np.arange(n_roads), lines_per)
    heading = rng.uniform(0, 2 * np.pi, n_roads)[road] + rng.normal(0, 0.5, n_lines)
    direction = np.stack([np.cos(heading), np.sin(heading)], 1) * STEP
    # from a line's start to the next line's: the line itself, then the jump
    reach = direction * (pts_per_line - 1)[:, None] + rng.normal(0, STEP, (n_lines, 2))
    line_in_road = np.arange(n_lines) - np.repeat(np.cumsum(lines_per) - lines_per, lines_per)
    start = road_start[road]
    for back in range(1, MAX_LINES):
        later = np.flatnonzero(line_in_road >= back)
        start[later] += reach[later - back]
    line_id = np.repeat(np.arange(n_lines), pts_per_line)
    t = np.arange(total) - np.repeat(np.cumsum(pts_per_line) - pts_per_line, pts_per_line)
    coords = start[line_id] + direction[line_id] * t[:, None]
    coords += rng.normal(0, 3e-5, (total, 2))
    coords = np.round(coords, 6)
    return Ragged(np.full(n_roads, TYPE_MULTILINESTRING, np.uint8), coords,
                  pts_per_line.astype(np.int64), lines_per.astype(np.int64))
