"""Integers drawn uniformly from ``[low, high)``, plus ``offset``."""

from __future__ import annotations

import numpy as np


def make(spec: dict, rng, values_per_record: np.ndarray) -> np.ndarray:
    v = rng.integers(int(spec["low"]), int(spec["high"]), len(values_per_record))
    return (int(spec.get("offset", 0)) + v).astype(spec["dtype"])
