"""Geo tokenizer: coordinates -> discrete token streams for trajectory LMs.

Tokens are Z-order cells at a fixed grid order within a bounding box
(6 bits/axis by default => vocab 4096), so spatially-nearby points share
token prefixes — exactly the locality FP-delta exploits on the storage side.
Special tokens: 0=PAD, 1=BOS, 2=EOS (cell ids shift by 3).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.sfc import quantize, z_key

PAD, BOS, EOS = 0, 1, 2
N_SPECIAL = 3


class GeoTokenizer:
    def __init__(self, bbox: tuple[float, float, float, float], order: int = 6):
        self.bbox = bbox
        self.order = order
        self.vocab = (1 << (2 * order)) + N_SPECIAL

    def encode_points(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        xq = quantize(np.asarray(x, np.float64), self.bbox[0], self.bbox[2], self.order)
        yq = quantize(np.asarray(y, np.float64), self.bbox[1], self.bbox[3], self.order)
        return (z_key(xq, yq) + N_SPECIAL).astype(np.int32)

    def decode_tokens(self, tokens: np.ndarray) -> np.ndarray:
        """Token -> cell-center coordinates (lossy by construction).

        Inverts :func:`repro_torch.core.sfc.quantize` (floor onto a 2^order-1
        lattice): cell q spans [q, q+1) * span/(2^order - 1)."""
        t = np.asarray(tokens, np.uint64) - N_SPECIAL
        xq = _compact_bits(t).astype(np.float64)
        yq = _compact_bits(t >> np.uint64(1)).astype(np.float64)
        n = (1 << self.order) - 1
        xs = self.bbox[0] + (xq + 0.5) / n * (self.bbox[2] - self.bbox[0])
        ys = self.bbox[1] + (yq + 0.5) / n * (self.bbox[3] - self.bbox[1])
        return np.stack([xs, ys], 1)

    def encode_trajectories(self, cols, max_len: int) -> np.ndarray:
        """GeometryColumns (trajectories) -> (n, max_len) int32 with BOS/EOS."""
        starts = cols.record_value_starts()
        counts = np.diff(np.append(starts, cols.n_values))
        toks = self.encode_points(cols.x, cols.y)
        n = cols.n_records
        out = np.full((n, max_len), PAD, np.int32)
        out[:, 0] = BOS
        for i in range(n):
            k = min(int(counts[i]), max_len - 2)
            out[i, 1 : 1 + k] = toks[starts[i] : starts[i] + k]
            out[i, 1 + k] = EOS
        return out


def _compact_bits(v: np.ndarray) -> np.ndarray:
    """Inverse of Morton spreading: gather every other bit."""
    v = v.astype(np.uint64) & np.uint64(0x5555555555555555)
    v = (v | (v >> np.uint64(1))) & np.uint64(0x3333333333333333)
    v = (v | (v >> np.uint64(2))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    v = (v | (v >> np.uint64(4))) & np.uint64(0x00FF00FF00FF00FF)
    v = (v | (v >> np.uint64(8))) & np.uint64(0x0000FFFF0000FFFF)
    v = (v | (v >> np.uint64(16))) & np.uint64(0x00000000FFFFFFFF)
    return v
