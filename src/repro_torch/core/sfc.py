"""Space-filling-curve sort keys (paper §4): Z-curve and Hilbert curve.

Both operate on coordinates quantized to a ``2^order`` grid over a bounding
box and return uint64 keys; sorting records by key clusters spatially-nearby
records so page [min,max] statistics become tight (paper Figure 7). Fully
vectorized; the Hilbert transform iterates ``order`` times over the arrays.
"""

from __future__ import annotations

import numpy as np


def quantize(v: np.ndarray, lo: float, hi: float, order: int) -> np.ndarray:
    """Map values in [lo, hi] to integers in [0, 2^order)."""
    span = max(hi - lo, 1e-300)
    q = ((v - lo) / span * (2**order - 1)).astype(np.uint64)
    return np.clip(q, 0, 2**order - 1).astype(np.uint64)


def _spread_bits(v: np.ndarray) -> np.ndarray:
    """Insert a 0 bit between each of the low 32 bits (Morton spreading)."""
    v = v.astype(np.uint64) & np.uint64(0xFFFFFFFF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
    v = (v | (v << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    v = (v | (v << np.uint64(2))) & np.uint64(0x3333333333333333)
    v = (v | (v << np.uint64(1))) & np.uint64(0x5555555555555555)
    return v


def z_key(xq: np.ndarray, yq: np.ndarray) -> np.ndarray:
    """Morton (Z-order) key from quantized coordinates."""
    return _spread_bits(xq) | (_spread_bits(yq) << np.uint64(1))


def hilbert_key(xq: np.ndarray, yq: np.ndarray, order: int = 16) -> np.ndarray:
    """Hilbert curve distance of quantized points (vectorized xy2d)."""
    x = xq.astype(np.uint64).copy()
    y = yq.astype(np.uint64).copy()
    d = np.zeros(x.shape, dtype=np.uint64)
    s = np.uint64(1) << np.uint64(order - 1)
    one = np.uint64(1)
    while s > 0:
        rx = ((x & s) > 0).astype(np.uint64)
        ry = ((y & s) > 0).astype(np.uint64)
        d += s * s * ((np.uint64(3) * rx) ^ ry)
        # rotate quadrant
        swap = ry == 0
        flip = swap & (rx == 1)
        xf = np.where(flip, s - one - x, x)
        yf = np.where(flip, s - one - y, y)
        x_new = np.where(swap, yf, xf)
        y_new = np.where(swap, xf, yf)
        x, y = x_new, y_new
        s >>= one
    return d


def sort_keys(
    cx: np.ndarray, cy: np.ndarray, method: str, order: int = 16,
    bbox: tuple[float, float, float, float] | None = None,
) -> np.ndarray:
    """Sort keys for record centroids; ``method`` in {'z', 'hilbert'}."""
    if bbox is None:
        bbox = (float(cx.min()), float(cy.min()), float(cx.max()), float(cy.max()))
    xq = quantize(np.asarray(cx, np.float64), bbox[0], bbox[2], order)
    yq = quantize(np.asarray(cy, np.float64), bbox[1], bbox[3], order)
    if method == "z":
        return z_key(xq, yq)
    if method == "hilbert":
        return hilbert_key(xq, yq, order)
    raise ValueError(f"unknown SFC method {method!r} (use 'z' or 'hilbert')")
