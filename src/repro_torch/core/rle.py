"""Run-length + bit-packed encodings for the type column and level streams.

Paper §3.1 uses RLE for the geometry ``type`` column ("virtually a constant"
for single-type datasets). Repetition/definition levels are 2-bit values
(paper §2); like Parquet we pick per-chunk between RLE and fixed-width
bit-packing, whichever is smaller, with a 1-byte mode tag.

The packed layout is :mod:`.bitstream`'s (LSB-first in little-endian 64-bit
words), so a width that divides 8 never crosses a byte. The writer's level
streams have widths 1 (``type_rep``, ``defn``) and 2 (``rep``, levels 0-3):
those are packed by shifting values into bytes and unpacked through a
256-entry byte table, one gather per byte. No writer makes a wider level
stream; one would go through the bit stream.
"""

from __future__ import annotations

import struct

import numpy as np

from repro_torch import obs

from .bitstream import bytes_to_words, pack_tokens, unpack_fixed, words_to_bytes

MODE_RLE = 0
MODE_PACKED = 1


def _byte_table(width: int) -> np.ndarray:
    """Row ``b`` holds the ``8 // width`` values byte ``b`` packs, first value
    in the low bits, as one unsigned integer of ``8 // width`` bytes."""
    k = 8 // width
    b = np.arange(256, dtype=np.uint8)[:, None]
    vals = (b >> (np.arange(k, dtype=np.uint8) * width)) & np.uint8((1 << width) - 1)
    return np.ascontiguousarray(vals).view(f"<u{k}").reshape(256)


_BYTE_TABLES = {w: _byte_table(w) for w in (1, 2)}   # the level streams' widths


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
    return bytes([MODE_PACKED]) + struct.pack("<BI", width, n) + pack_levels(values, width)


def pack_levels(values: np.ndarray, width: int) -> bytes:
    """``values`` (uint8, each below ``2**width``) bit-packed at ``width``:
    the bytes of :func:`.bitstream.pack_tokens` cut to ``ceil(width * n / 8)``."""
    values = np.ascontiguousarray(values, dtype=np.uint8)
    n = len(values)
    if width not in _BYTE_TABLES:
        words, total = pack_tokens(values.astype(np.uint64), np.full(n, width, dtype=np.int64))
        return words_to_bytes(words, total)
    k = 8 // width
    padded = np.zeros(-(-n // k) * k, np.uint8)
    padded[:n] = values
    lanes = padded.reshape(-1, k)
    out = lanes[:, 0].copy()
    for j in range(1, k):
        out |= lanes[:, j] << np.uint8(j * width)
    return out.tobytes()


def unpack_levels(buf, count: int, width: int) -> np.ndarray:
    """The first ``count`` ``width``-bit values of the packed bytes ``buf``,
    as uint8 (the inverse of :func:`pack_levels`)."""
    if width not in _BYTE_TABLES:
        return unpack_fixed(bytes_to_words(buf), 0, count, width).astype(np.uint8)
    packed = np.frombuffer(buf, np.uint8, count=(width * count + 7) // 8)
    return _BYTE_TABLES[width][packed].view(np.uint8)[:count]


def decode_levels(buf: bytes) -> np.ndarray:
    mode = buf[0]
    body = memoryview(buf)[1:]
    if mode == MODE_RLE:
        out = rle_decode(body)
        obs.count("levels.rle_values", len(out))
        return out
    width, count = struct.unpack_from("<BI", body, 0)
    with (obs.span("levels.unpack", cat="decode", values=count, width=width)
          if obs.enabled() else obs.NULL_SPAN):
        out = unpack_levels(body[5:], count, width)
    obs.count("levels.packed_values", count)
    return out
