"""Vectorized arbitrary-width bit packing.

This is the host-side (numpy) bit plane used by the FP-delta codec
(:mod:`repro_torch.core.fp_delta`). Values are packed LSB-first into a stream of
little-endian ``uint64`` words: a value written at bit offset ``o`` with width
``w`` occupies bits ``o .. o+w-1`` of the stream, where bit ``b`` of the stream
is bit ``b % 64`` of word ``b // 64``.

Everything here is fully vectorized — there are no per-value Python loops.
Writes use ``np.bitwise_or.at`` scatter (values may share words); reads use
gather + shift + mask.
"""

from __future__ import annotations

import numpy as np

_U64 = np.uint64
_ONE = _U64(1)
_FULL = _U64(0xFFFFFFFFFFFFFFFF)

# mask[w] = w low bits set; a table gather beats the branchy shift dance
_MASK_TABLE = np.array([(1 << w) - 1 for w in range(64)] + [(1 << 64) - 1],
                       dtype=_U64)


def width_mask(width):
    """All-ones mask of ``width`` bits (scalar or array; width==64 -> full)."""
    if isinstance(width, (int, np.integer)):
        return _MASK_TABLE[int(width)]
    return _MASK_TABLE[np.asarray(width, dtype=np.int64)]


def _scatter_or(words: np.ndarray, idx: np.ndarray, vals: np.ndarray) -> None:
    """``words[idx] |= vals`` for non-decreasing ``idx``.

    Equivalent to ``np.bitwise_or.at`` but ~5x faster: contributions are
    grouped per word with one ``reduceat`` (pack_tokens guarantees ascending
    word order, and all contributions to a word are bit-disjoint).
    """
    if not len(idx):
        return
    starts = np.concatenate([[0], np.flatnonzero(idx[1:] != idx[:-1]) + 1])
    words[idx[starts]] |= np.bitwise_or.reduceat(vals, starts)


def pack_tokens(values: np.ndarray, widths: np.ndarray) -> tuple[np.ndarray, int]:
    """Pack ``values[i]`` at width ``widths[i]`` bits, consecutively.

    Returns ``(words, total_bits)`` where ``words`` is a uint64 array with one
    trailing spill word so readers may always gather ``words[idx + 1]``.
    """
    values = np.ascontiguousarray(values, dtype=_U64)
    widths = np.ascontiguousarray(widths, dtype=np.int64)
    if values.shape != widths.shape or values.ndim != 1:
        raise ValueError("values/widths must be equal-length 1-D arrays")
    ends = np.cumsum(widths, dtype=np.int64)
    total_bits = int(ends[-1]) if len(ends) else 0
    starts = ends - widths
    nwords = (total_bits + 63) // 64 + 1  # +1 spill word
    words = np.zeros(nwords, dtype=_U64)
    if not len(values):
        return words, 0
    v = values & width_mask(widths)
    word_idx = (starts >> 6).astype(np.int64)
    shift = (starts & 63).astype(_U64)
    lo = v << shift
    # High spill: v >> (64 - shift); shift-by-64 is undefined, mask the case out.
    inv = (_U64(64) - shift) & _U64(63)
    hi = np.where(shift == _U64(0), _U64(0), v >> inv)
    _scatter_or(words, word_idx, lo)
    _scatter_or(words, word_idx + 1, hi)
    return words, total_bits


def unpack_at(words: np.ndarray, bit_offsets: np.ndarray, width: int) -> np.ndarray:
    """Gather ``width``-bit values at arbitrary bit offsets (vectorized).

    ``words`` must carry the trailing spill word produced by
    :func:`pack_tokens`/:func:`bytes_to_words` so ``words[idx + 1]`` is always
    in bounds. This is the primitive behind the FP-delta fixpoint decode,
    where escape markers shift later token offsets by a non-uniform amount.
    """
    offs = np.asarray(bit_offsets, dtype=np.int64)
    if offs.size == 0 or width == 0:
        return np.zeros(offs.shape, dtype=_U64)
    word_idx = (offs >> 6).astype(np.int64)
    shift = (offs & 63).astype(_U64)
    lo = words[word_idx] >> shift
    inv = (_U64(64) - shift) & _U64(63)
    hi = np.where(shift == _U64(0), _U64(0), words[word_idx + 1] << inv)
    return (lo | hi) & width_mask(width)


def unpack_fixed(words: np.ndarray, start_bit: int, count: int, width: int) -> np.ndarray:
    """Read ``count`` consecutive ``width``-bit values starting at ``start_bit``.

    ``words`` must have the trailing spill word produced by :func:`pack_tokens`
    (or :func:`bytes_to_words`).
    """
    if count <= 0:
        return np.zeros(0, dtype=_U64)
    if width == 0:
        return np.zeros(count, dtype=_U64)
    offs = start_bit + np.int64(width) * np.arange(count, dtype=np.int64)
    return unpack_at(words, offs, width)


def marker_candidates(words: np.ndarray, n: int) -> np.ndarray:
    """Bit positions where ``n`` consecutive set bits start (sorted).

    A log-shift AND ladder over the packed words: after each step ``r[i]``
    means "bits ``i .. i+span-1`` are all set", spans doubling until they
    cover ``n``. Runs longer than ``n`` yield one candidate per possible
    start. Used by the FP-delta escape resolver: a reset marker is ``n``
    consecutive ones at a token-aligned position, so the (rare) candidates
    are the only places an escape can hide — no per-value scan needed.
    """
    r = words
    span = 1
    while span < n:
        t = min(span, n - span)
        nxt = np.empty_like(r)
        nxt[:-1] = r[1:]
        nxt[-1] = 0
        r = r & ((r >> _U64(t)) | (nxt << _U64(64 - t)))
        span += t
    nzw = np.flatnonzero(r)
    if not len(nzw):
        return np.zeros(0, dtype=np.int64)
    bits = np.unpackbits(
        np.frombuffer(r[nzw].astype("<u8").tobytes(), dtype=np.uint8),
        bitorder="little",
    )
    hot = np.flatnonzero(bits)
    return nzw[hot >> 6] * 64 + (hot & 63)


def read_one(words: np.ndarray, start_bit: int, width: int) -> int:
    """Scalar read of a single value (header parsing)."""
    return int(unpack_fixed(words, start_bit, 1, width)[0])


def words_to_bytes(words: np.ndarray, total_bits: int) -> bytes:
    """Serialize the packed stream to the minimal little-endian byte string."""
    nbytes = (total_bits + 7) // 8
    return words.astype("<u8").tobytes()[:nbytes]


def bytes_to_words(buf) -> np.ndarray:
    """Parse a bytes-like buffer into a uint64 word array with a spill word.

    Accepts any contiguous buffer (``bytes``, ``bytearray``, ``memoryview``
    slices of a coalesced-I/O read) without materializing an intermediate
    padded byte string.
    """
    n = len(buf)
    body = n >> 3
    tail = n & 7
    words = np.zeros(body + (1 if tail else 0) + 1, dtype=_U64)  # +1 spill
    if body:
        words[:body] = np.frombuffer(buf, dtype="<u8", count=body)
    if tail:
        last = np.zeros(8, dtype=np.uint8)
        last[:tail] = np.frombuffer(buf, dtype=np.uint8, count=tail, offset=body << 3)
        words[body] = last.view("<u8")[0]
    return words
