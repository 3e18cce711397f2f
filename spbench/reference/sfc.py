"""Hilbert-curve sort keys of record bbox centres (the paper's §4 sort).

Centres are quantised to a ``2^order`` grid over the bbox of the centres,
as the repository's writer does, and mapped to their distance along the
curve of the iterative xy2d transform (at each level, from the top: the
quadrant digit ``(3 * rx) ^ ry``, then a swap of x and y when ``ry == 0``,
after complementing both when ``rx == 1``). Swap and complement commute, so
the transform carried to the lower bits is one of four states, and the
curve is walked four levels a step through a table of (state, 4 bits of x,
4 bits of y) -> (8 bits of distance, next state). The CPU tests hold it
equal to the writer's keys.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


def quantize(v: np.ndarray, lo: float, hi: float, order: int) -> np.ndarray:
    span = max(hi - lo, 1e-300)
    q = ((v - lo) / span * (2**order - 1)).astype(np.uint64)
    return np.clip(q, 0, 2**order - 1).astype(np.uint64)


@lru_cache(maxsize=None)
def _table(levels: int) -> tuple[np.ndarray, np.ndarray]:
    n = 1 << levels
    dist = np.zeros((4, n, n), np.uint64)
    nxt = np.zeros((4, n, n), np.uint8)
    for state in range(4):
        for bx in range(n):
            for by in range(n):
                swap, flip, d = state >> 1, state & 1, 0
                for lv in range(levels - 1, -1, -1):
                    rx, ry = (bx >> lv) & 1, (by >> lv) & 1
                    if swap:
                        rx, ry = ry, rx
                    rx, ry = rx ^ flip, ry ^ flip
                    d = (d << 2) | ((3 * rx) ^ ry)
                    if ry == 0:
                        flip ^= rx
                        swap ^= 1
                dist[state, bx, by] = d
                nxt[state, bx, by] = (swap << 1) | flip
    return dist.reshape(-1), nxt.reshape(-1)


def hilbert_key(xq: np.ndarray, yq: np.ndarray, order: int) -> np.ndarray:
    xq, yq = np.asarray(xq, np.uint64), np.asarray(yq, np.uint64)
    d = np.zeros(xq.shape, np.uint64)
    state = np.zeros(xq.shape, np.intp)
    left = order
    while left > 0:
        k = min(4, left)
        left -= k
        dist, nxt = _table(k)
        mask = np.uint64((1 << k) - 1)
        bx = ((xq >> np.uint64(left)) & mask).astype(np.intp)
        by = ((yq >> np.uint64(left)) & mask).astype(np.intp)
        idx = (state << (2 * k)) | (bx << k) | by
        d = (d << np.uint64(2 * k)) | dist[idx]
        state = nxt[idx].astype(np.intp)
    return d


def hilbert_sort_keys(cx: np.ndarray, cy: np.ndarray, order: int) -> np.ndarray:
    bbox = (float(cx.min()), float(cy.min()), float(cx.max()), float(cy.max()))
    xq = quantize(np.asarray(cx, np.float64), bbox[0], bbox[2], order)
    yq = quantize(np.asarray(cy, np.float64), bbox[1], bbox[3], order)
    return hilbert_key(xq, yq, order)
