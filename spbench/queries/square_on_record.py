"""Square boxes centred on a record, grown to a record selectivity.

The mix's ``selectivity`` range is cut into ``strata`` targets
(:func:`spbench.traffic.targets`); the sequence is ``cycles`` rounds of
them in one fixed order (:func:`spbench.traffic.spread_order`), so every
seed asks for the same sizes in the same order; the seed draws the data and
where the boxes lie. Each box is a square in degrees, centred on the bbox
centre of a record drawn at random (so boxes land where the data is, as
users' viewports do), and grown until the share of records whose bbox it
meets is the target: the half-side is the k-th smallest distance, in the
max norm, from the centre to the records' bboxes, over a sample of
``sample_records`` records drawn from the seed.
"""

from __future__ import annotations

import numpy as np

from spbench.traffic import Query, spread_order, targets


def make(mix: dict, oracle, seed: int) -> tuple[Query, list[Query]]:
    rng = np.random.default_rng([seed % 2**64, 1])
    n = oracle.n_records
    sample = rng.integers(0, n, min(n, int(mix["sample_records"])))
    xmin, xmax = oracle.xmin[sample], oracle.xmax[sample]
    ymin, ymax = oracle.ymin[sample], oracle.ymax[sample]
    cx, cy = oracle.centres()

    def box(target: float) -> Query:
        c = int(rng.integers(0, n))
        x, y = float(cx[c]), float(cy[c])
        d = np.maximum(np.maximum(xmin - x, x - xmax), np.maximum(ymin - y, y - ymax))
        d = np.maximum(d, 0.0)
        k = min(len(d) - 1, max(0, int(round(target * len(d))) - 1))
        h = float(np.partition(d, k)[k])
        return Query((x - h, y - h, x + h, y + h), float(target))

    ts = targets(mix)
    warm = box(float(ts[len(ts) // 2]))
    seq = [box(float(t)) for _ in range(int(mix["cycles"])) for t in spread_order(ts)]
    return warm, seq
