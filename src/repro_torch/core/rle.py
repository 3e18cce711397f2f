"""Run-length + bit-packed encodings for the type column and level streams.

Paper §3.1 uses RLE for the geometry ``type`` column ("virtually a constant"
for single-type datasets). Repetition/definition levels are 2-bit values
(paper §2); like Parquet we pick per-chunk between RLE and fixed-width
bit-packing, whichever is smaller, with a 1-byte mode tag.
"""

from __future__ import annotations

import struct

import numpy as np

from .bitstream import bytes_to_words, pack_tokens, unpack_fixed, words_to_bytes

MODE_RLE = 0
MODE_PACKED = 1


def rle_encode(values: np.ndarray) -> bytes:
    """RLE of small non-negative ints: (uint32 count, uint8 value) pairs."""
    values = np.ascontiguousarray(values, dtype=np.uint8)
    n = len(values)
    if n == 0:
        return struct.pack("<I", 0)
    boundaries = np.flatnonzero(values[1:] != values[:-1]) + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [n]])
    counts = (ends - starts).astype(np.uint32)
    run_values = values[starts]
    out = struct.pack("<I", len(counts))
    interleaved = np.empty(len(counts), dtype=[("c", "<u4"), ("v", "u1")])
    interleaved["c"] = counts
    interleaved["v"] = run_values
    return out + interleaved.tobytes()


def rle_decode(buf: bytes) -> np.ndarray:
    (n_runs,) = struct.unpack_from("<I", buf, 0)
    if n_runs == 0:
        return np.zeros(0, dtype=np.uint8)
    rec = np.frombuffer(buf, dtype=[("c", "<u4"), ("v", "u1")], count=n_runs, offset=4)
    return np.repeat(rec["v"], rec["c"].astype(np.int64))


def _bits_needed(values: np.ndarray) -> int:
    if len(values) == 0:
        return 1
    m = int(values.max())
    return max(1, m.bit_length())


def encode_levels(values: np.ndarray) -> bytes:
    """Level stream encoder: min(RLE, bit-packed) with a mode tag.

    Both encodings have exactly predictable sizes (RLE: 4 + 5*runs bytes;
    packed: 5 + ceil(width*n/8) bytes), so the winner is chosen analytically
    and only that encoding is materialized — the loser is never built.
    """
    values = np.ascontiguousarray(values, dtype=np.uint8)
    n = len(values)
    n_runs = 1 + int(np.count_nonzero(values[1:] != values[:-1])) if n else 0
    rle_size = 4 + 5 * n_runs
    width = _bits_needed(values)
    packed_size = 5 + (width * n + 7) // 8
    if rle_size <= packed_size:
        return bytes([MODE_RLE]) + rle_encode(values)
    words, total = pack_tokens(
        values.astype(np.uint64), np.full(n, width, dtype=np.int64)
    )
    return bytes([MODE_PACKED]) + struct.pack("<BI", width, n) + words_to_bytes(words, total)


def decode_levels(buf: bytes) -> np.ndarray:
    mode = buf[0]
    body = buf[1:]
    if mode == MODE_RLE:
        return rle_decode(body)
    width, count = struct.unpack_from("<BI", body, 0)
    words = bytes_to_words(body[5:])
    return unpack_fixed(words, 0, count, width).astype(np.uint8)
