"""Porto taxi trajectories (the paper's PT table): MultiPoint random walks.

A frozen copy of ``porto_taxi_like`` in the repository's synthetic data
module: the same draws in the same order, so a seed gives the same trips.
"""

from __future__ import annotations

import numpy as np

from ..ragged import TYPE_MULTIPOINT, Ragged

PORTO_BBOX = (-8.70, 41.10, -8.50, 41.25)


def generate(sizes: dict, seed: int) -> Ragged:
    n_traj = int(sizes["n_traj"])
    mean_pts = int(sizes.get("mean_pts", 48))
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
    coords = np.round(coords, 6)
    # MultiPoint: one part a point
    return Ragged(np.full(n_traj, TYPE_MULTIPOINT, np.uint8), coords,
                  np.ones(total, np.int64), npts.astype(np.int64))
