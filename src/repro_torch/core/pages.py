"""Page-level encode/decode: FP-delta or raw, plus general-purpose compression.

A *page* is the minimum reading unit (paper Appendix A.2): ~1MB of one
column's values, record-aligned so the light-weight index can skip whole
records. Each page is encoded (FP-delta §3 / raw) then optionally compressed
(gzip per the paper's experiments, or zstd as a modern extension) and carries
[min, max] statistics (§4).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field

import numpy as np

from repro_torch import obs

try:
    import zstandard as _zstd
except ImportError:  # pragma: no cover - zstd optional
    _zstd = None

from .bitstream import bytes_to_words
from .fp_delta import (
    HEADER_BITS,
    FPDeltaPlan,
    _check_out,
    fp_delta_decode,
    fp_delta_encode,
    fp_delta_encode_pages,
    fp_delta_plan,
)

ENC_FP_DELTA = "fp_delta"
ENC_RAW = "raw"

CODEC_NONE = "none"
CODEC_GZIP = "gzip"
CODEC_ZSTD = "zstd"


class CodecUnavailable(RuntimeError):
    """Raised when a file/page requests a codec whose wheel is not installed.

    The byte format itself is fine — install the codec (e.g. ``zstandard``)
    or rewrite the file with ``codec="gzip"``/``"none"``.
    """


def have_codec(codec: str) -> bool:
    """True if ``codec`` can be used in this environment."""
    if codec in (CODEC_NONE, CODEC_GZIP):
        return True
    if codec == CODEC_ZSTD:
        return _zstd is not None
    return False


def best_codec() -> str:
    """Strongest general-purpose codec usable here: zstd if present, else gzip."""
    return CODEC_ZSTD if have_codec(CODEC_ZSTD) else CODEC_GZIP


def compress(buf, codec: str) -> bytes:
    if codec == CODEC_NONE:
        return buf
    if codec == CODEC_GZIP:
        return zlib.compress(buf, 6)
    if codec == CODEC_ZSTD:
        if _zstd is None:
            raise CodecUnavailable(
                "codec 'zstd' requires the 'zstandard' package (not installed); "
                "use codec='gzip' or codec='none' instead"
            )
        return _zstd.ZstdCompressor(level=3).compress(buf)
    raise ValueError(f"unknown codec {codec!r}")


def decompress(buf, codec: str):
    if codec == CODEC_NONE:
        return buf
    if codec == CODEC_GZIP:
        return zlib.decompress(buf)
    if codec == CODEC_ZSTD:
        if _zstd is None:
            raise CodecUnavailable(
                "codec 'zstd' requires the 'zstandard' package (not installed); "
                "this file cannot be decoded until it is available"
            )
        return _zstd.ZstdDecompressor().decompress(buf)
    raise ValueError(f"unknown codec {codec!r}")


@dataclass
class PageMeta:
    """Footer metadata for one page (offsets are file-absolute)."""

    offset: int
    nbytes: int
    count: int              # number of values
    rec_start: int          # first record (row-group relative)
    rec_count: int
    vmin: float
    vmax: float
    encoding: str
    n_bits: int             # FP-delta n* (0 => raw mode inside fp_delta)
    n_resets: int
    crc: int | None = None  # checksum of the stored bytes (format v2 files)
    nnan: int | None = None  # NaN count (extra-column pages with zone stats)

    def to_dict(self) -> dict:
        d = self.__dict__.copy()
        if d.get("crc") is None:
            # v1 files carry no checksums; omitting the key keeps their
            # footers byte-identical to the pre-checksum format
            del d["crc"]
        if d.get("nnan") is None:
            # coordinate pages and pre-zone-map files omit the key, keeping
            # their footers byte-identical to the earlier format
            del d["nnan"]
        return d

    @staticmethod
    def from_dict(d: dict) -> "PageMeta":
        return PageMeta(**d)


def encode_page(values: np.ndarray, encoding: str, codec: str) -> tuple[bytes, dict]:
    """Encode one page of numeric values; returns (bytes, stats dict)."""
    values = np.ascontiguousarray(values)
    if encoding == ENC_FP_DELTA:
        payload, st = fp_delta_encode(values)
        n_bits, n_resets = st.n_bits, st.n_resets
    elif encoding == ENC_RAW:
        payload, n_bits, n_resets = values.tobytes(), 0, 0
    else:
        raise ValueError(f"unknown encoding {encoding!r}")
    out = compress(payload, codec)
    stats = {
        "n_bits": n_bits,
        "n_resets": n_resets,
        "raw_nbytes": values.nbytes,
        "encoded_nbytes": len(payload),
        "stored_nbytes": len(out),
    }
    return out, stats


def decode_page(
    buf, meta: PageMeta, dtype, codec: str, out: np.ndarray | None = None
) -> np.ndarray:
    """Decode one page; ``buf`` may be any bytes-like (memoryview slice).

    ``out``, if given, receives the decoded values in place (must be a
    contiguous 1-D array of ``meta.count`` elements) — the coalesced reader
    uses this to decode straight into preallocated column arrays.
    """
    payload = decompress(buf, codec)
    if meta.encoding == ENC_FP_DELTA:
        return fp_delta_decode(payload, meta.count, dtype, out=out)
    if meta.encoding == ENC_RAW:
        dtype = np.dtype(dtype)
        vals = np.frombuffer(payload, dtype=dtype, count=meta.count)
        if out is not None:
            # same strict contract as fp_delta_decode: a wrong-dtype buffer
            # would otherwise silently value-cast (lossy) instead of
            # receiving the stored bits
            _check_out(out, meta.count, dtype)
            out[:] = vals
            return out
        return vals.copy()
    raise ValueError(f"unknown encoding {meta.encoding!r}")


def page_plan(buf, meta: PageMeta, dtype, codec: str) -> FPDeltaPlan:
    """Parse one stored page into an :class:`FPDeltaPlan`.

    The front half of the device read path: decompress + header parse on
    the host (escapes resolve where the plan is executed); the returned
    plan is what ``repro_torch.kernels.fp_delta.decode_pages`` batches onto
    the accelerator.
    Only FP-delta pages have plans (raw pages are a plain ``frombuffer``).
    """
    if meta.encoding != ENC_FP_DELTA:
        raise ValueError(f"page_plan requires fp_delta pages, got {meta.encoding!r}")
    return fp_delta_plan(decompress(buf, codec), meta.count, dtype)


def page_stream_plan(buf, meta: PageMeta, dtype, codec: str) -> FPDeltaPlan:
    """Like :func:`page_plan`, but accepts **every** coordinate encoding.

    Raw pages are mapped onto a *synthetic raw-mode plan* — a zero byte
    (standing in for the fp_delta ``n* = 0`` header) prepended to the stored
    values, so every value sits at ``HEADER_BITS + i * W`` exactly like a
    raw-mode fp_delta payload. The device page-stream decode then treats
    both encodings uniformly (each value a W-bit anchor), which is what lets
    the fused decode→refine path cover whole row groups regardless of how
    individual pages were encoded. Bit-identical to ``np.frombuffer`` on the
    payload (little-endian word math either way). Traced as the
    ``page.plan`` span.
    """
    with (obs.span("page.plan", cat="plan", values=meta.count, encoding=meta.encoding)
          if obs.enabled() else obs.NULL_SPAN):
        if meta.encoding == ENC_FP_DELTA:
            return page_plan(buf, meta, dtype, codec)
        if meta.encoding != ENC_RAW:
            raise ValueError(f"unknown encoding {meta.encoding!r}")
        dtype = np.dtype(dtype)
        width = dtype.itemsize * 8
        if width not in (32, 64):
            raise TypeError(f"unsupported dtype {dtype}")
        payload = decompress(buf, codec)
        if meta.count == 0:
            return FPDeltaPlan(dtype, width, 0, 0, 0, np.zeros(1, np.uint64), 0)
        shifted = bytearray(1 + len(payload))
        shifted[1:] = payload
        assert HEADER_BITS == 8, "synthetic raw plan assumes a one-byte header"
        return FPDeltaPlan(dtype, width, 0, meta.count, 0, bytes_to_words(shifted), 0)


def encode_pages(
    values: np.ndarray, bounds: list[tuple[int, int]], encoding: str, codec: str
) -> list[tuple[bytes, dict]]:
    """Batch-encode value ranges ``[v0, v1)`` of one column as pages.

    For FP-delta this shares a single column-wide delta/zigzag/bit-count pass
    across all pages (byte-identical to per-page :func:`encode_page`); raw
    pages are plain slices. Compression still applies per page.
    """
    values = np.ascontiguousarray(values)
    out: list[tuple[bytes, dict]] = []
    if encoding == ENC_FP_DELTA:
        encoded = fp_delta_encode_pages(values, bounds)
        for (payload, st), (v0, v1) in zip(encoded, bounds):
            comp = compress(payload, codec)
            out.append((comp, {
                "n_bits": st.n_bits, "n_resets": st.n_resets,
                "raw_nbytes": values[v0:v1].nbytes,
                "encoded_nbytes": len(payload), "stored_nbytes": len(comp),
            }))
        return out
    if encoding == ENC_RAW:
        for v0, v1 in bounds:
            payload = values[v0:v1].tobytes()
            comp = compress(payload, codec)
            out.append((comp, {
                "n_bits": 0, "n_resets": 0,
                "raw_nbytes": values[v0:v1].nbytes,
                "encoded_nbytes": len(payload), "stored_nbytes": len(comp),
            }))
        return out
    raise ValueError(f"unknown encoding {encoding!r}")


def plan_page_splits(
    record_value_starts: np.ndarray, n_values: int, page_values: int
) -> list[tuple[int, int]]:
    """Record-aligned page boundaries targeting ``page_values`` per page.

    Returns a list of (rec_start, rec_stop) per page. Records bigger than a
    page get a page of their own (a page always holds >= 1 record).
    """
    n_records = len(record_value_starts)
    if n_records == 0:
        return []
    bounds = np.append(record_value_starts, n_values)
    pages: list[tuple[int, int]] = []
    r = 0
    while r < n_records:
        target = bounds[r] + page_values
        # furthest record whose values end within the target
        nxt = int(np.searchsorted(bounds, target, side="right")) - 1
        nxt = max(nxt, r + 1)
        nxt = min(nxt, n_records)
        pages.append((r, nxt))
        r = nxt
    return pages
