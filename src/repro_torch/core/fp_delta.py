"""FP-delta: lossless delta encoding for floating-point coordinates.

Paper-exact implementation of Spatial Parquet §3 (Algorithms 1, 2 and 3):

1. Reinterpret each IEEE-754 value as a two's-complement integer
   (``cast-long``); delta consecutive values with wrapping arithmetic.
2. Zigzag-encode: ``(delta >> W-1) ^ (delta << 1)`` (arithmetic shift).
3. Choose the storage-optimal delta width ``n*`` from the exact cost model
   ``S(n) = n * (|X|-1) + W * sum_{i>n} h[i]`` over the histogram ``h`` of
   significant-bit counts (Algorithm 3, suffix sums).
4. Emit: 8-bit header ``n*``, the first value raw (W bits), then per delta
   either its zigzag in ``n*`` bits, or the all-ones *reset marker* followed by
   the raw W-bit value when the zigzag does not fit (or collides with the
   marker).

``n* == 0`` signals raw mode (the paper's "skip the algorithm altogether" path
when the computed saving is nil): every value is stored raw at W bits.

The codec is width-parametric: ``W=64`` covers float64/int64 (the paper's
default), ``W=32`` covers float32/int32 (paper footnote 1; also the variant our
TPU Pallas kernels implement, and the one used for checkpoint compression).

Hot-path structure (this module is the decode-CPU bottleneck of the whole
read path, so every stage is one numpy pass):

* **Encode** computes the zigzag deltas and the significant-bit histogram
  exactly once and shares them between the ``n*`` optimizer and the token
  emitter (:func:`fp_delta_encode`); :func:`fp_delta_encode_pages`
  batch-encodes every page of a column from a single column-wide delta pass.
* **Decode** (:func:`fp_delta_decode`) has no per-segment Python loop; work
  never scales with the value count outside whole-array vector ops. The
  exact escape count is recovered from the payload length (W >= 32 > 7 bits
  of byte padding, so the division is exact), then marker positions are
  resolved one of two ways. Sparse streams (a handful of escapes) use a
  vectorized fixpoint: token offsets are guessed assuming no escapes,
  markers found, offsets re-derived from the escape cumsum, repeated until
  stable (typically <= 2 rounds; a stable assignment is necessarily the
  unique correct one — token 0's offset is known, and by induction every
  later offset is determined by the flags before it). Denser streams use the
  candidate scan: one log-shift AND ladder over the packed words finds every
  position where ``n`` consecutive ones start (``marker_candidates``), and a
  short walk over those candidates — O(#escapes), not O(#values) — pins the
  token-aligned ones as the true markers. Either way, reconstruction is ONE
  segmented cumsum over all reset segments at once: cumsum the inline deltas
  with escapes zeroed, then add a per-segment correction (raw value minus
  the running sum at the escape) spread with ``np.repeat``.
* ``out=`` lets callers (the coalesced reader) decode straight into a slice
  of a preallocated coordinate array, eliminating list-append +
  ``np.concatenate`` from the read path.
* **Decode is split into plan + execute.** :func:`fp_delta_plan` parses
  the header (``n*``, the first value, the exact escape count) and keeps
  the packed words; the only inherently sequential part of Algorithm 2 —
  escape resolution, i.e. locating every token once reset markers shift
  later offsets — runs on the host only when a plan's ``(offsets, flags)``
  are first read (:func:`resolve_escapes`). :func:`fp_delta_execute`
  finishes on the host (gather, un-zigzag, segmented cumsum);
  ``repro_torch.kernels.fp_delta`` consumes the very same plans to run that
  second half on the accelerator, where a CUDA kernel finds the reset
  markers in the words on the card and the host resolves nothing, so the
  two back ends can never disagree about the format.
  :func:`fp_delta_decode` is plan + host execute and stays the oracle.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from repro_torch import obs

from .bitstream import (
    bytes_to_words,
    marker_candidates,
    pack_tokens,
    read_one,
    unpack_at,
    unpack_fixed,
    words_to_bytes,
)

_SIGNED = {32: np.int32, 64: np.int64}
_UNSIGNED = {32: np.uint32, 64: np.uint64}

HEADER_BITS = 8

_FIXPOINT_MAX_ROUNDS = 10
# sparse/dense resolver switch: the fixpoint needs ~E+1 rounds, so beyond a
# handful of escapes the candidate-scan resolver is strictly better
_FIXPOINT_MAX_ESCAPES = 4


def _as_int_bits(x: np.ndarray) -> tuple[np.ndarray, int]:
    """View the input as signed two's-complement ints; return (ints, W)."""
    x = np.ascontiguousarray(x)
    if x.dtype in (np.float64, np.int64, np.uint64):
        return x.view(np.int64), 64
    if x.dtype in (np.float32, np.int32, np.uint32):
        return x.view(np.int32), 32
    raise TypeError(f"fp_delta supports 32/64-bit element types, got {x.dtype}")


def zigzag(delta: np.ndarray, width: int) -> np.ndarray:
    """Zigzag-encode signed deltas to unsigned (paper Alg. 1 line 9)."""
    s = _SIGNED[width]
    d = delta.astype(s, copy=False)
    return ((d >> s(width - 1)) ^ (d << s(1))).view(_UNSIGNED[width])


def unzigzag(z: np.ndarray, width: int) -> np.ndarray:
    """Inverse zigzag (paper Alg. 2 line 9): (z >>> 1) ^ -(z & 1)."""
    u = _UNSIGNED[width]
    z = z.astype(u, copy=False)
    neg = u(0) - (z & u(1))  # wraps to all-ones when LSB set
    return ((z >> u(1)) ^ neg).view(_SIGNED[width])


def significant_bits(z: np.ndarray, width: int) -> np.ndarray:
    """Number of significant bits of each unsigned value (0 for value 0).

    One pass via the float64 exponent field, with an exact fix-up for the
    one case float rounding can overshoot (values just below a power of
    two round up, inflating the exponent by one).
    """
    z64 = np.asarray(z).astype(np.uint64, copy=False)
    f = z64.astype(np.float64)
    e = ((f.view(np.uint64) >> np.uint64(52)) & np.uint64(0x7FF)).astype(np.int64)
    e -= 1022  # unbias: e = #bits of the rounded float (f in [2^(e-1), 2^e))
    es = np.clip(e - 1, 0, 63).astype(np.uint64)
    over = (z64 >> es) == 0  # z < 2^(e-1): rounding overshot, e is one high
    sig = np.minimum(np.where(over, e - 1, e), 64)
    return np.where(z64 == 0, 0, sig)


def _zigzag_deltas(x: np.ndarray) -> tuple[np.ndarray, int]:
    xi, width = _as_int_bits(x)
    delta = xi[1:] - xi[:-1]  # wrapping two's-complement subtraction
    return zigzag(delta, width), width


def delta_bit_histogram(x: np.ndarray) -> np.ndarray:
    """Histogram h[n] = #deltas needing exactly n significant bits (Fig 8)."""
    xi, width = _as_int_bits(x)
    if len(xi) < 2:
        return np.zeros(width + 1, dtype=np.int64)
    z, width = _zigzag_deltas(x)
    nbits = significant_bits(z, width)
    return np.bincount(nbits, minlength=width + 1).astype(np.int64)


def best_bits_from_histogram(h: np.ndarray, n_deltas: int, width: int) -> int:
    """Paper Algorithm 3 from a precomputed histogram: exact argmin_n S(n)."""
    if n_deltas <= 0:
        return 0
    suffix = np.cumsum(h[::-1])[::-1]  # suffix[n] = #deltas needing >= n bits
    s_all = np.arange(width + 1, dtype=np.int64) * n_deltas
    s_all[:-1] += width * suffix[1:]
    s_all[0] = width * n_deltas  # n=0 == raw mode: every value raw
    return int(np.argmin(s_all[:width]))  # n in [0, width)


def compute_best_delta_bits(x: np.ndarray) -> int:
    """Paper Algorithm 3: exact argmin_n S(n) via suffix-summed histogram."""
    xi, width = _as_int_bits(x)
    n_deltas = len(xi) - 1
    if n_deltas <= 0:
        return 0
    return best_bits_from_histogram(delta_bit_histogram(x), n_deltas, width)


@dataclass(frozen=True)
class FPDeltaStats:
    """Encoder-side accounting (feeds benchmarks and page metadata)."""

    n_values: int
    n_bits: int          # chosen n*
    n_resets: int        # deltas escaped via reset marker
    payload_bits: int    # total encoded bits incl. header


def _encode_tokens(
    raw_bits: np.ndarray, z: np.ndarray, width: int, n: int
) -> tuple[bytes, FPDeltaStats]:
    """Emit the token stream for one page from precomputed zigzag deltas.

    ``raw_bits``: every value's W-bit pattern as uint64; ``z``: the page's
    zigzag deltas as uint64 (``len(z) == len(raw_bits) - 1``).
    """
    n_values = len(raw_bits)
    if n_values == 0:
        return b"", FPDeltaStats(0, 0, 0, 0)

    if n == 0 or n_values == 1:
        # Raw mode: header n=0, then every value raw at W bits.
        vals = np.concatenate([[np.uint64(0)], raw_bits])
        widths = np.concatenate([[HEADER_BITS], np.full(n_values, width, np.int64)])
        words, total = pack_tokens(vals, widths)
        return words_to_bytes(words, total), FPDeltaStats(n_values, 0, 0, total)

    marker = np.uint64((1 << n) - 1)
    overflow = z >= marker  # any significant bit above n-1, or == marker

    n_deltas = n_values - 1
    n_over = int(overflow.sum())
    n_tokens = 2 + n_deltas + n_over  # header, first value, deltas (+escapes)
    vals = np.empty(n_tokens, dtype=np.uint64)
    widths = np.empty(n_tokens, dtype=np.int64)
    vals[0], widths[0] = np.uint64(n), HEADER_BITS
    vals[1], widths[1] = raw_bits[0], width
    # Position of each delta's first token: one extra slot per prior escape.
    pos = 2 + np.arange(n_deltas, dtype=np.int64) + np.cumsum(overflow) - overflow
    vals[pos] = np.where(overflow, marker, z)
    widths[pos] = n
    if n_over:
        esc = pos[overflow] + 1
        vals[esc] = raw_bits[1:][overflow]
        widths[esc] = width
    words, total = pack_tokens(vals, widths)
    return words_to_bytes(words, total), FPDeltaStats(n_values, n, n_over, total)


def fp_delta_encode(x: np.ndarray, n_bits: int | None = None) -> tuple[bytes, FPDeltaStats]:
    """Encode a 1-D array of 32/64-bit values. Returns (payload, stats).

    One-pass: the zigzag deltas are computed once and shared between the
    ``n*`` optimizer (Algorithm 3) and the token emitter. The default path is
    the single-page case of :func:`fp_delta_encode_pages` so the two can
    never diverge.
    """
    xi, width = _as_int_bits(x)
    if n_bits is None:
        return fp_delta_encode_pages(xi, [(0, len(xi))])[0]

    n = int(n_bits)
    if not (0 <= n < width):
        raise ValueError(f"n_bits must be in [0, {width}), got {n}")
    n_values = len(xi)
    if n_values == 0:
        return b"", FPDeltaStats(0, 0, 0, 0)
    raw_bits = xi.view(_UNSIGNED[width]).astype(np.uint64)
    if n_values >= 2:
        z = zigzag(xi[1:] - xi[:-1], width).astype(np.uint64)
    else:
        z = np.zeros(0, dtype=np.uint64)
    return _encode_tokens(raw_bits, z, width, n)


def fp_delta_encode_pages(
    x: np.ndarray, bounds: list[tuple[int, int]]
) -> list[tuple[bytes, FPDeltaStats]]:
    """Batch-encode value ranges ``[v0, v1)`` of one column as independent pages.

    The column-wide zigzag deltas and significant-bit counts are computed in a
    single pass; each page then only pays for its own histogram (``bincount``
    over a slice) and token packing. Page ``[v0, v1)`` uses column deltas
    ``d[v0 : v1-1]`` — the cross-page delta at ``v1-1`` is never encoded, so
    the output is byte-identical to encoding each slice separately.
    """
    xi, width = _as_int_bits(x)
    u = _UNSIGNED[width]
    raw_bits = xi.view(u).astype(np.uint64)
    if len(xi) >= 2:
        z = zigzag(xi[1:] - xi[:-1], width).astype(np.uint64)
        nbits = significant_bits(z, width)
    else:
        z = np.zeros(0, dtype=np.uint64)
        nbits = np.zeros(0, dtype=np.int64)

    out = []
    for v0, v1 in bounds:
        cnt = v1 - v0
        if cnt <= 0:
            out.append((b"", FPDeltaStats(0, 0, 0, 0)))
            continue
        zp = z[v0 : v1 - 1]
        h = np.bincount(nbits[v0 : v1 - 1], minlength=width + 1).astype(np.int64)
        n = best_bits_from_histogram(h, cnt - 1, width)
        out.append(_encode_tokens(raw_bits[v0:v1], zp, width, n))
    return out


def _to_signed_scalar(base: np.uint64, width: int):
    return np.uint64(base).astype(_UNSIGNED[width]).view(_SIGNED[width])


def _resolve_escapes_fixpoint(
    words: np.ndarray, start_bit: int, n_deltas: int, n: int, width: int, n_escapes: int
) -> tuple[np.ndarray, np.ndarray] | None:
    """Vectorized fixpoint: find each delta token's bit offset and marker flag.

    Token ``j`` starts at ``start_bit + n*j + width*E_j`` where ``E_j`` is the
    number of escapes among deltas ``< j``. Guess ``E = 0``, unpack, flag
    markers, recompute ``E`` as the (clipped) exclusive cumsum, repeat until
    stable. A stable assignment is the unique correct one (token 0's offset
    is known; each later offset is determined by the flags before it). Each
    round locks in at least one more escape, so sparse streams converge in
    about ``n_escapes + 1`` rounds — typically <= 2. Returns
    ``(offsets, flags)`` or None when not converged (denser streams use
    :func:`_resolve_escapes_scan` instead).
    """
    marker = np.uint64((1 << n) - 1)
    idx = np.arange(n_deltas, dtype=np.int64) * np.int64(n) + np.int64(start_bit)
    esc_before = np.zeros(n_deltas, dtype=np.int64)
    w64 = np.int64(width)
    for _ in range(_FIXPOINT_MAX_ROUNDS):
        offs = idx + w64 * esc_before
        tok = unpack_at(words, offs, n)
        flags = tok == marker
        # clip keeps every offset inside the payload even mid-fixpoint
        new_esc = np.minimum(np.cumsum(flags) - flags, n_escapes)
        if np.array_equal(new_esc, esc_before):
            return offs, flags
        esc_before = new_esc
    return None


def _resolve_escapes_scan(
    words: np.ndarray, start_bit: int, n_deltas: int, n: int, width: int, n_escapes: int
) -> tuple[np.ndarray, np.ndarray]:
    """Escape resolution for any marker density, exact and O(#escapes).

    A reset marker is ``n`` consecutive set bits at a token-aligned offset.
    :func:`marker_candidates` finds every bit position where ``n`` ones start
    (one vectorized log-shift ladder over the packed words); an inline token
    can never equal the marker, so a *token-aligned* candidate inside the
    token region is always a real escape. The walk below consumes candidates
    left to right — skipping unaligned ones (run spill from neighbouring
    token/raw bits) — and jumps ``n + W`` bits past each confirmed marker.
    Work is proportional to escapes found plus stray candidates, never to
    the value count.
    """
    cands = marker_candidates(words, n)
    esc_tok = np.empty(n_escapes, dtype=np.int64)
    found = 0
    pos = start_bit  # bit offset of the current segment's first token
    j0 = 0           # token index of the current segment's first token
    for c in cands.tolist():
        if found == n_escapes:
            break
        if c < pos:
            continue
        d, r = divmod(c - pos, n)
        if r:
            continue  # candidate not token-aligned: spill from data bits
        j = j0 + d
        if j >= n_deltas:
            break
        esc_tok[found] = j
        found += 1
        pos = c + n + width  # skip the marker and its raw value
        j0 = j + 1
    flags = np.zeros(n_deltas, dtype=bool)
    flags[esc_tok[:found]] = True
    esc_before = np.cumsum(flags) - flags
    offs = (
        np.int64(start_bit)
        + np.int64(n) * np.arange(n_deltas, dtype=np.int64)
        + np.int64(width) * esc_before
    )
    return offs, flags


@dataclass(frozen=True)
class FPDeltaPlan:
    """Parsed decode plan for one page (the device-decode contract).

    The plan holds what the page's header and length give: the token width,
    the first value, the packed words and the exact escape count. The only
    inherently sequential part of Algorithm 2 — locating every token once
    reset markers shift later offsets — is left to whoever executes the
    plan: :func:`fp_delta_execute` (host numpy) reads ``offsets``/``flags``,
    which resolve on the host at first access (:func:`resolve_escapes`,
    counted in ``page.resolve.host_pages``); the CUDA page stream in
    :mod:`repro_torch.kernels.fp_delta` finds the markers on the card and
    never reads them. What remains (fixed-width gather, escape injection,
    segmented cumsum, un-zigzag, float bitcast) is embarrassingly parallel.

    ``offsets[j]``/``flags[j]`` describe delta token ``j`` (``n_values - 1``
    entries): its absolute bit offset in ``words`` and whether it is the
    reset marker (the escaped raw W-bit value then sits at ``offsets[j] +
    n``). Raw mode (``n == 0``) has no delta tokens: every value is stored
    raw at ``width`` bits starting from bit ``HEADER_BITS``.
    """

    dtype: np.dtype
    width: int            # 32 or 64
    n: int                # token width n* (0 => raw mode)
    n_values: int
    first: int            # raw W-bit pattern of value 0 (0 when empty/raw)
    words: np.ndarray     # uint64 packed stream incl. trailing spill word
    n_escapes: int        # escape count recovered from the payload length

    @cached_property
    def _resolved(self) -> tuple[np.ndarray, np.ndarray]:
        return resolve_escapes(self)

    @property
    def offsets(self) -> np.ndarray:
        """(n_deltas,) int64 token bit offsets (host resolution)."""
        return self._resolved[0]

    @property
    def flags(self) -> np.ndarray:
        """(n_deltas,) bool: True where the token is a marker (host resolution)."""
        return self._resolved[1]


def _check_out(out: np.ndarray | None, n_values: int, dtype: np.dtype) -> None:
    if out is None:
        return
    if out.dtype != dtype or out.ndim != 1 or len(out) != n_values:
        raise ValueError("out must be a 1-D array of n_values elements of dtype")
    if not out.flags.c_contiguous:
        raise ValueError("out must be C-contiguous")


_EMPTY_OFFS = np.zeros(0, dtype=np.int64)
_EMPTY_FLAGS = np.zeros(0, dtype=bool)


def fp_delta_plan(payload, n_values: int, dtype) -> FPDeltaPlan:
    """Parse a payload's header (Algorithm 2 front half, escapes left
    unresolved: see :class:`FPDeltaPlan`). ``payload`` may be any
    bytes-like buffer (``bytes``, ``memoryview``)."""
    dtype = np.dtype(dtype)
    width = dtype.itemsize * 8
    if width not in (32, 64):
        raise TypeError(f"unsupported dtype {dtype}")
    if n_values == 0:
        return FPDeltaPlan(dtype, width, 0, 0, 0, np.zeros(1, np.uint64), 0)

    words = bytes_to_words(payload)
    n = read_one(words, 0, HEADER_BITS)
    cursor = HEADER_BITS
    if n == 0:  # raw mode: every value raw at W bits, no delta tokens
        return FPDeltaPlan(dtype, width, 0, n_values, 0, words, 0)

    first = read_one(words, cursor, width)
    cursor += width
    n_deltas = n_values - 1
    # Exact escape count from the payload length: total bits are
    # HEADER + W + n*D + W*E plus < 8 bits of byte padding, and W >= 32 > 7,
    # so the integer division is exact for well-formed payloads.
    n_escapes = (len(payload) * 8 - cursor - n * n_deltas) // width
    n_escapes = max(0, min(int(n_escapes), n_deltas))
    return FPDeltaPlan(dtype, width, n, n_values, first, words, n_escapes)


def resolve_escapes(plan: FPDeltaPlan) -> tuple[np.ndarray, np.ndarray]:
    """Resolve a plan's escapes on the host: ``(offsets, flags)`` of its
    delta tokens (empty for raw, empty and single-value pages). Sparse
    streams take the fixpoint, denser ones the candidate scan. Counted in
    ``page.resolve.host_pages``."""
    n, n_deltas = plan.n, plan.n_values - 1
    if n == 0 or n_deltas <= 0:
        return _EMPTY_OFFS, _EMPTY_FLAGS
    obs.count("page.resolve.host_pages")
    cursor = HEADER_BITS + plan.width
    if plan.n_escapes == 0:
        offs = cursor + np.int64(n) * np.arange(n_deltas, dtype=np.int64)
        return offs, np.zeros(n_deltas, dtype=bool)
    resolved = None
    if plan.n_escapes <= _FIXPOINT_MAX_ESCAPES:
        resolved = _resolve_escapes_fixpoint(
            plan.words, cursor, n_deltas, n, plan.width, plan.n_escapes)
    if resolved is None:
        resolved = _resolve_escapes_scan(
            plan.words, cursor, n_deltas, n, plan.width, plan.n_escapes)
    return resolved


def fp_delta_execute(plan: FPDeltaPlan, out: np.ndarray | None = None) -> np.ndarray:
    """Finish a resolved plan on the host (Algorithm 2 back half).

    This is the oracle the accelerator path must match bit-for-bit.
    """
    dtype, width = plan.dtype, plan.width
    s, u = _SIGNED[width], _UNSIGNED[width]
    _check_out(out, plan.n_values, dtype)
    if plan.n_values == 0:
        return out if out is not None else np.zeros(0, dtype=dtype)

    out_arr = out if out is not None else np.empty(plan.n_values, dtype=dtype)
    out_int = out_arr.view(s)
    words = plan.words

    if plan.n == 0:
        raws = unpack_fixed(words, HEADER_BITS, plan.n_values, width)
        out_int[:] = raws.astype(u).view(s)
        return out_arr

    out_int[0] = _to_signed_scalar(np.uint64(plan.first), width)
    n_deltas = plan.n_values - 1
    if n_deltas == 0:
        return out_arr

    n, offs, flags = plan.n, plan.offsets, plan.flags
    if plan.n_escapes == 0:
        z = unpack_at(words, offs, n)
        deltas = unzigzag(z.astype(u), width)
        out_int[1:] = out_int[0] + np.cumsum(deltas, dtype=s)
        return out_arr

    tok = unpack_at(words, offs, n)
    # One segmented cumsum over all reset segments at once: cumsum the inline
    # deltas (escapes contribute 0), then add a per-segment correction so each
    # escape restarts the running sum at its raw value.
    deltas = np.where(flags, s(0), unzigzag(tok.astype(u), width))
    running = out_int[0] + np.cumsum(deltas, dtype=s)
    esc_idx = np.flatnonzero(flags)
    if not len(esc_idx):  # malformed payload claimed escapes; decode best-effort
        out_int[1:] = running
        return out_arr
    raws = unpack_at(words, offs[esc_idx] + n, width)
    raw_signed = raws.astype(u).view(s)
    corr = raw_signed - running[esc_idx]
    reps = np.diff(np.append(esc_idx, n_deltas))
    out_int[1 : 1 + esc_idx[0]] = running[: esc_idx[0]]
    out_int[1 + esc_idx[0] :] = running[esc_idx[0] :] + np.repeat(corr, reps)
    return out_arr


def fp_delta_decode(
    payload, n_values: int, dtype, out: np.ndarray | None = None
) -> np.ndarray:
    """Decode ``n_values`` elements of ``dtype`` (paper Algorithm 2).

    ``payload`` may be any bytes-like buffer (``bytes``, ``memoryview``).
    ``out``, if given, must be a contiguous 1-D array of exactly ``n_values``
    elements of ``dtype``; the decode writes into it and returns it, letting
    callers fill slices of a preallocated column without a concat pass.
    Wrong-dtype/wrong-length/non-contiguous buffers raise ``ValueError``
    before any byte of the payload is parsed.
    """
    dtype = np.dtype(dtype)
    if dtype.itemsize * 8 not in (32, 64):
        raise TypeError(f"unsupported dtype {dtype}")
    _check_out(out, n_values, dtype)
    return fp_delta_execute(fp_delta_plan(payload, n_values, dtype), out=out)


def encoded_size_bits(x: np.ndarray, n: int) -> int:
    """Exact S(n) for diagnostics (Equation 2 plus header/first-value cost)."""
    xi, width = _as_int_bits(x)
    if len(xi) < 2:
        return HEADER_BITS + width * len(xi)
    if n == 0:
        return HEADER_BITS + width * len(xi)
    h = delta_bit_histogram(x)
    suffix = np.cumsum(h[::-1])[::-1]
    over = int(suffix[n + 1]) if n + 1 <= width else 0
    return HEADER_BITS + width + n * (len(xi) - 1) + width * over
