"""eBird sightings (the paper's eB table): Point records around hotspots.

A frozen copy of ``ebird_like`` in the repository's synthetic data module
(its hotspot count, spread and Pareto shape are the configuration's sizes,
with the same defaults): the same draws in the same order. ``shuffled``
keeps the source unsorted, as the paper notes eBird is.
"""

from __future__ import annotations

import numpy as np

from ..ragged import TYPE_POINT, Ragged

US_BBOX = (-124.0, 25.0, -67.0, 49.0)


def generate(sizes: dict, seed: int) -> Ragged:
    n_points = int(sizes["n_points"])
    n_hot = int(sizes.get("n_hot", 2000))
    sigma = float(sizes.get("sigma_deg", 0.01))
    shape = float(sizes.get("pareto_shape", 1.2))
    rng = np.random.default_rng(seed)
    hots = np.stack([rng.uniform(US_BBOX[0], US_BBOX[2], n_hot),
                     rng.uniform(US_BBOX[1], US_BBOX[3], n_hot)], 1)
    weights = rng.pareto(shape, n_hot) + 1
    weights /= weights.sum()
    hid = rng.choice(n_hot, n_points, p=weights)
    coords = hots[hid] + rng.normal(0, sigma, (n_points, 2))
    coords = np.round(coords, 6)
    if sizes.get("shuffled", True):
        coords = coords[rng.permutation(n_points)]
    ones = np.ones(n_points, np.int64)
    return Ragged(np.full(n_points, TYPE_POINT, np.uint8), coords, ones, ones.copy())
