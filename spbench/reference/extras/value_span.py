"""``step`` times the values of a record less one (a trip's duration at one
GPS fix every ``step`` seconds); draws nothing."""

from __future__ import annotations

import numpy as np


def make(spec: dict, rng, values_per_record: np.ndarray) -> np.ndarray:
    return (float(spec["step"]) * (values_per_record - 1)).astype(spec["dtype"])
