"""A generated geometry column in ragged form, in input order.

Every record holds one geometry (no collections), made of parts of one or
more points each, so the Dremel levels are plain: repetition 0 at a
record's first value, 2 at the first value of each further part, 3 inside
a part; definition 1 everywhere (no empty parts).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

TYPE_POINT = 1        # the format's geometry type codes
TYPE_MULTIPOINT = 4


@dataclass
class Ragged:
    types: np.ndarray             # uint8, one a record
    coords: np.ndarray            # (n_values, 2) float64
    part_sizes: np.ndarray        # int64, values a part
    parts_per_record: np.ndarray  # int64

    @property
    def n_records(self) -> int:
        return len(self.types)

    @property
    def n_values(self) -> int:
        return len(self.coords)

    def values_per_record(self) -> np.ndarray:
        csum = np.concatenate([[0], np.cumsum(self.part_sizes)])
        ends = np.cumsum(self.parts_per_record)
        return csum[ends] - csum[ends - self.parts_per_record]

    def rep_levels(self) -> np.ndarray:
        """Repetition level of every value, input order."""
        rep = np.full(self.n_values, 3, np.uint8)
        rep[np.cumsum(self.part_sizes) - self.part_sizes] = 2
        vpr = self.values_per_record()
        rep[np.cumsum(vpr) - vpr] = 0
        return rep


def ragged_ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenated ``arange(s, s + c)`` for each pair."""
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    excl = np.cumsum(counts) - counts
    return (np.repeat(np.asarray(starts, np.int64) - excl, counts)
            + np.arange(total, dtype=np.int64))


def bits(a: np.ndarray) -> np.ndarray:
    """The IEEE-754 (or integer) bit patterns of ``a``, as signed integers."""
    a = np.ascontiguousarray(a)
    return a.view({1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[a.dtype.itemsize])
