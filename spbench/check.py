"""The comparison that decides ``correct``.

Every answer the window produced (and the warm-up's) is held against the
reference's, field by field, and each kind of difference is counted over
the run. Every count has the limit 0: the read is exact (the file format is
lossless and the refine is a float compare), so a single differing bit,
level, record, page or extra value fails the run.
"""

from __future__ import annotations

import numpy as np

# name -> what it counts; every limit is 0
CHECKS = {
    "unanswered": "queries that raised",
    "pages_off": "|pages read - reference| summed (index pruning)",
    "scanned_off": "|records scanned - reference| summed (index pruning)",
    "records_off": "|records returned - reference| summed (refine)",
    "levels_off": "differing or missing levels and types (file round trip, gather)",
    "x_bits_off": "differing or missing x bit patterns (decode, gather)",
    "y_bits_off": "differing or missing y bit patterns (decode, gather)",
    "extras_off": "differing or missing extra-column values",
}
LIMIT = 0


def mismatches(a: np.ndarray, b: np.ndarray) -> int:
    """Positions that differ, counting every position only one side has."""
    m = min(len(a), len(b))
    return abs(len(a) - len(b)) + int(np.count_nonzero(a[:m] != b[:m]))


def compare(got, want) -> dict:
    """Counts of each kind of difference between two :class:`Answer` s."""
    if got is None:
        return {"unanswered": 1}
    return {
        "pages_off": abs(got.pages_read - want.pages_read),
        "scanned_off": abs(got.records_scanned - want.records_scanned),
        "records_off": abs(got.n - want.n),
        "levels_off": (mismatches(got.rep, want.rep) + mismatches(got.defn, want.defn)
                       + mismatches(got.types, want.types)
                       + mismatches(got.type_rep, want.type_rep)),
        "x_bits_off": mismatches(got.x, want.x),
        "y_bits_off": mismatches(got.y, want.y),
        "extras_off": sum(mismatches(got.extras.get(k, np.zeros(0, v.dtype)), v)
                          for k, v in want.extras.items())
                      + len(set(got.extras) - set(want.extras)),
    }


def total(counts: list[dict]) -> dict:
    out = {k: 0 for k in CHECKS}
    for c in counts:
        for k, v in c.items():
            out[k] += int(v)
    return out


def passed(totals: dict) -> bool:
    return all(v <= LIMIT for v in totals.values())
