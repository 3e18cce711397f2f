"""The miniblock codec; page-stream decode, fused decode→refine, and
survivor gather.

Miniblock codec (:func:`encode`, :func:`decode`, :func:`to_bytes`,
:func:`from_bytes`, :func:`compress_array`, :func:`decompress_array`):
lossless 32-bit compression of arbitrary-length float32/int32 arrays in
self-contained blocks of ``MINIBLOCK`` values (format in :mod:`.ref`). The
input is padded with its last element (zero deltas cost nothing); the dense
device stream compacts on the host into the ``FPD2`` byte format.

Page stream: batched device execution of ``FPDeltaPlan``s (the
paper-exact page format of :mod:`repro_torch.core.fp_delta`), consumed by
``SpatialParquetReader.read_columnar``. Many pages concatenate into one flat
value stream (:func:`build_page_stream`), kept compact: the packed words and
a table of a few numbers a page, the header's escape counts among them.
Every value's token bit offset, token width and anchor flag is a closed form
of these and the positions of the escaped values. On CUDA two kernels of
their own write them on the card (``csrc/stream_expand.cu``): one finds the
reset markers in the words (the sequential part of the decode, one warp step
an escape), one expands the descriptors; the host resolves nothing. The
plain host versions (:func:`escape_resolve_ref`, :func:`expand_stream_ref`)
serve the CPU path and the tests. One decode launch covers a whole chunk of
a row group. :func:`decode_refine_stream` chains the decode with the
per-record order-key min/max and the bbox survivor test of
:mod:`repro_torch.kernels.minmax`, so only the record mask and then the
surviving values (:func:`gather_stream_values`) leave the device.

Operands are built as numpy arrays on the host and moved to the device once
by :func:`stream_from_numpy`; the expanded descriptors are byte for byte the
arrays the JAX package builds on its host. Every device function follows the
device of its tensors: CUDA tensors launch the kernels, CPU tensors run the
plain versions.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import torch_device
from repro_torch.core.bitstream import unpack_at
from repro_torch.core.columnar import TorchCoords
from repro_torch.core.fp_delta import HEADER_BITS, FPDeltaPlan, fp_delta_execute
from repro_torch.kernels.minmax import (
    bbox_query_keys,
    inf_keys64,
    keep_from_minmax,
    keys64,
    segminmax_refine,
)

from . import kernel, ref
from .ref import MAX_EXC, MINIBLOCK, STREAM_BLOCK

_MAGIC = b"FPD2"  # FP-Delta Miniblock v2 (patched)

# ------------------------------------------------------------ miniblock codec
@dataclass
class MiniblockStream:
    """Encoded stream as tensors on one device (dense, pre-compaction)."""

    packed: torch.Tensor     # (n_blocks, MINIBLOCK) int32, first w*32 words valid
    widths: torch.Tensor     # (n_blocks,) int32 in {0} | WIDTHS
    anchors: torch.Tensor    # (n_blocks,) int32
    exc_idx: torch.Tensor    # (n_blocks, MAX_EXC) int32
    exc_val: torch.Tensor    # (n_blocks, MAX_EXC) int32 (raw zigzag)
    exc_count: torch.Tensor  # (n_blocks,) int32
    n_values: int            # unpadded element count

    @property
    def n_blocks(self) -> int:
        return int(self.packed.shape[0])

    def compact_bits(self) -> int:
        """Size of the compacted stream in bits."""
        return ref.stream_size_bits(self.widths, self.exc_count)


def _pad_to_blocks(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Flatten, view int32 as float32, pad with the last element to whole
    blocks; an empty input becomes one zero block."""
    x = x.reshape(-1)
    if x.dtype == torch.int32:
        x = x.view(torch.float32)
    if x.dtype != torch.float32:
        raise TypeError(f"miniblock codec is 32-bit only, got {x.dtype}")
    n = x.shape[0]
    padded = -(-n // MINIBLOCK) * MINIBLOCK
    if padded == 0:
        padded = MINIBLOCK
        x = torch.zeros(MINIBLOCK, dtype=torch.float32, device=x.device)
    elif padded != n:
        x = torch.cat([x, x[-1:].expand(padded - n)])
    return x.reshape(-1, MINIBLOCK).contiguous(), n


def encode(x, *, device="cuda") -> MiniblockStream:
    """Encode a float32/int32 array (numpy or tensor, any shape) on
    ``device``: the kernel on ``"cuda"``, the plain version on ``"cpu"``."""
    dev = torch_device(device)
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    blocks, n = _pad_to_blocks(x.to(dev))
    if dev.type == "cuda":
        return MiniblockStream(*kernel.encode_blocks(blocks), n)
    return MiniblockStream(*ref.encode_blocks_ref(blocks), n)


def decode(stream: MiniblockStream, *, out_dtype=torch.float32) -> torch.Tensor:
    """Decode on the stream's device -> the (n_values,) float32 tensor, or
    its int32 bit patterns for ``out_dtype=torch.int32``."""
    args = (stream.packed, stream.widths, stream.anchors,
            stream.exc_idx, stream.exc_val, stream.exc_count)
    if stream.packed.device.type == "cuda":
        x = kernel.decode_blocks(*args)
    else:
        x = ref.decode_blocks_ref(*args)
    flat = x.reshape(-1)[: stream.n_values]
    if out_dtype == torch.int32:
        return flat.view(torch.int32)
    return flat


def to_bytes(stream: MiniblockStream) -> bytes:
    """Compact the dense stream into contiguous ``FPD2`` bytes (host side)."""
    packed = stream.packed.cpu().numpy()
    widths = stream.widths.cpu().numpy().astype(np.uint8)
    anchors = stream.anchors.cpu().numpy()
    counts = stream.exc_count.cpu().numpy().astype(np.uint8)
    exc_idx = stream.exc_idx.cpu().numpy().astype(np.uint16)
    exc_val = stream.exc_val.cpu().numpy().astype("<i4")
    n_blocks = len(widths)
    valid = (widths.astype(np.int64) * MINIBLOCK) // 32
    mask = np.arange(MINIBLOCK)[None, :] < valid[:, None]
    payload = packed[mask]  # row-major → block order preserved
    emask = np.arange(MAX_EXC)[None, :] < counts[:, None].astype(np.int64)
    head = _MAGIC + struct.pack("<QI", stream.n_values, n_blocks)
    return (head + widths.tobytes() + counts.tobytes()
            + anchors.astype("<i4").tobytes()
            + exc_idx[emask].astype("<u2").tobytes() + exc_val[emask].tobytes()
            + payload.astype("<i4").tobytes())


def from_bytes(buf: bytes, *, device="cuda") -> MiniblockStream:
    """Parse ``FPD2`` bytes into a dense stream on ``device``."""
    dev = torch_device(device)
    if buf[:4] != _MAGIC:
        raise ValueError("not an FPD2 stream")
    n_values, n_blocks = struct.unpack_from("<QI", buf, 4)
    off = 4 + 12
    widths = np.frombuffer(buf, np.uint8, n_blocks, off).astype(np.int32)
    off += n_blocks
    counts = np.frombuffer(buf, np.uint8, n_blocks, off).astype(np.int32)
    off += n_blocks
    anchors = np.frombuffer(buf, "<i4", n_blocks, off).astype(np.int32)
    off += 4 * n_blocks
    n_exc = int(counts.sum())
    eidx = np.frombuffer(buf, "<u2", n_exc, off)
    off += 2 * n_exc
    eval_ = np.frombuffer(buf, "<i4", n_exc, off)
    off += 4 * n_exc
    valid = (widths.astype(np.int64) * MINIBLOCK) // 32
    payload = np.frombuffer(buf, "<i4", int(valid.sum()), off)
    packed = np.zeros((n_blocks, MINIBLOCK), np.int32)
    packed[np.arange(MINIBLOCK)[None, :] < valid[:, None]] = payload
    exc_idx = np.zeros((n_blocks, MAX_EXC), np.int32)
    exc_val = np.zeros((n_blocks, MAX_EXC), np.int32)
    emask = np.arange(MAX_EXC)[None, :] < counts[:, None]
    exc_idx[emask] = eidx
    exc_val[emask] = eval_

    def put(a):
        return torch.from_numpy(a).to(dev)

    return MiniblockStream(put(packed), put(widths), put(anchors), put(exc_idx),
                           put(exc_val), put(counts), n_values)


def compress_array(x, *, device="cuda") -> bytes:
    """One-shot lossless compression of a float32/int32 array (any shape)."""
    return to_bytes(encode(x, device=device))


def decompress_array(buf: bytes, shape, dtype=np.float32, *, device="cuda") -> np.ndarray:
    """Inverse of :func:`compress_array`: a numpy array of ``shape``/``dtype``."""
    want_i32 = np.dtype(dtype) == np.int32
    flat = decode(from_bytes(buf, device=device),
                  out_dtype=torch.int32 if want_i32 else torch.float32)
    return flat.cpu().numpy().reshape(shape).view(dtype)


# ------------------------------------------------------------ page stream
# Per-launch cap on packed payload bits. Token offsets are int32 bit
# addresses, so a launch must stay under 2^31 bits; 2^30 keeps that with a
# margin and still holds tens of millions of values (one launch covers a
# large share of a million-record row group).
_MAX_LAUNCH_BITS = 1 << 30


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pow2_bucket(x: int, floor: int) -> int:
    """Next power of two >= max(x, floor) (the reference's operand shapes)."""
    n = max(int(x), int(floor))
    return 1 << (n - 1).bit_length()


@dataclass
class PageStream:
    """Many pages concatenated into one device-decodable value stream, in
    compact form: each page's packed words and a table of the pages.

    Every token descriptor the decode needs is a closed form of these. For
    a page at stream position ``S`` with base bit ``B`` (its first word's
    bit address), token width ``n`` and value width ``W``, value ``0`` is a
    W-bit anchor at ``B + 8``; in raw mode (``n == 0``) value ``i`` is a
    W-bit anchor at ``B + 8 + W*i``; otherwise value ``i = j + 1`` (delta
    token ``j``, ``E_j`` escapes before it) is an n-bit delta at ``B + 8 + W
    + n*j + W*E_j``, or, when escaped, a W-bit anchor ``n`` bits further on
    (the raw value after the marker). The padding tail is W-bit anchors at
    bit 0. The CUDA path finds the escapes and expands the descriptors on
    the card (``csrc/stream_expand.cu``, in :func:`stream_from_numpy`);
    :func:`escape_resolve_ref` and :func:`expand_stream_ref` are the plain
    host versions, behind the ``escapes`` and ``tok_off``/``nbits``/``anchor``
    properties.
    """

    word_parts: tuple[np.ndarray, ...]  # each page's packed uint64 words, spill
                                        # word dropped, in stream order
    n_words: int            # int32 words of the padded buffer: a multiple of 128,
                            # >= 2 zero spill words after the last page
    page_table: np.ndarray  # (5, n_pages) int32, rows: value start, value
                            # count, base bit, n (0: raw), first escape index;
                            # pages with no values have no column
    plans: tuple[FPDeltaPlan, ...]  # the table's pages (host resolution only)
    n_escapes: int          # escaped values of all pages (their headers' counts)
    width: int              # 32 or 64 (uniform across the stream)
    counts: tuple[int, ...]  # per-page value counts (output split points)
    shape: tuple[int, int]  # (n_blocks, STREAM_BLOCK) of the padded stream

    @property
    def n_values(self) -> int:
        return sum(self.counts)

    @cached_property
    def words32(self) -> np.ndarray:
        """(n_words,) int32: the pages' words one after another, then zeros
        (host copy; the CUDA path copies each page to the card itself)."""
        wbuf = np.zeros(self.n_words // 2, "<u8")
        at = 0
        for w in self.word_parts:
            wbuf[at:at + len(w)] = w
            at += len(w)
        # the LE uint32 view keeps the bit layout: stream bit b = bit b%32 of word b//32
        return wbuf.view(np.int32)

    @cached_property
    def escapes(self) -> np.ndarray:
        """(n_escapes,) int32 ascending stream positions of the escaped
        values (host resolution)."""
        return escape_resolve_ref(self)

    @cached_property
    def _expanded(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return expand_stream_ref(self)

    @property
    def tok_off(self) -> np.ndarray:
        """(n_blocks, STREAM_BLOCK) int32 token bit offsets (host expansion)."""
        return self._expanded[0]

    @property
    def nbits(self) -> np.ndarray:
        """(n_blocks, STREAM_BLOCK) int32 token widths in [1, 64] (host expansion)."""
        return self._expanded[1]

    @property
    def anchor(self) -> np.ndarray:
        """(n_blocks, STREAM_BLOCK) int32 0/1, padding 1 (host expansion)."""
        return self._expanded[2]


def _token_bits(p: FPDeltaPlan) -> int:
    """Bits a plan's header, values and tokens take: what its escape count
    and value count say its payload holds, byte padding left out."""
    if p.n == 0:
        return HEADER_BITS + p.width * p.n_values
    return HEADER_BITS + p.width + p.n * (p.n_values - 1) + p.width * p.n_escapes


def build_page_stream(plans) -> PageStream:
    """Concatenate plans into one compact :class:`PageStream`.

    Each page keeps its packed words (placed word-aligned, one page after
    another, where the stream is copied) and adds a column to the page
    table, its first escape index the running sum of the headers' escape
    counts: the host work is a few numbers a page, never an array of one
    entry a value, no escape resolution and no copy of the payload. Total
    payload must stay under ``_MAX_LAUNCH_BITS`` (use :func:`decode_pages`,
    which chunks automatically). Traced as the ``stream.build`` span.
    """
    plans = list(plans)
    with (obs.span("stream.build", cat="plan", pages=len(plans),
                   values=sum(p.n_values for p in plans))
          if obs.enabled() else obs.NULL_SPAN) as sp:
        widths = {p.width for p in plans if p.n_values}
        if len(widths) > 1:
            raise ValueError(f"mixed widths in one page stream: {sorted(widths)}")
        width = widths.pop() if widths else 32

        word_base = 0  # uint64 words placed so far
        v_start = 0
        n_esc = 0
        wparts: list[np.ndarray] = []
        cols: list[tuple[int, int, int, int, int]] = []
        kept: list[FPDeltaPlan] = []
        counts: list[int] = []
        for p in plans:
            counts.append(p.n_values)
            if p.n_values == 0:
                continue
            w = p.words[:-1]  # drop the all-zero spill word; re-guarded globally
            if _token_bits(p) > 64 * len(w):
                raise ValueError("a page's tokens do not follow its escapes: its payload "
                                 "is shorter than its header's tokens")
            cols.append((v_start, p.n_values, word_base * 64, p.n, n_esc))
            n_esc += p.n_escapes  # 0 for raw and single-value pages
            kept.append(p)
            v_start += p.n_values
            word_base += len(w)
            wparts.append(w)

        total_bits = word_base * 64
        if total_bits > _MAX_LAUNCH_BITS:
            raise ValueError(
                f"page stream of {total_bits} bits exceeds the per-launch cap "
                f"of {_MAX_LAUNCH_BITS}; use decode_pages, which chunks pages "
                "across launches and host-decodes oversized single pages")

        nw = _pow2_bucket(_round_up(2 * word_base + 2, 128), 128)

        table = np.array(cols, np.int32).reshape(-1, 5).T.copy()
        n_blocks = _pow2_bucket(-(-max(v_start, 1) // STREAM_BLOCK), 1)
        sp.add(escapes=n_esc)
        return PageStream(tuple(wparts), nw, table, tuple(kept), n_esc, width,
                          tuple(counts), (n_blocks, STREAM_BLOCK))


def escape_resolve_ref(stream: PageStream) -> np.ndarray:
    """The plain host version of ``kernel.escape_resolve``: the stream
    positions of every escaped value, ascending, from each page's host
    resolution (``FPDeltaPlan.flags``). A page whose tokens do not hold
    exactly the escapes its payload length claims (fewer markers, or a
    marker after the last of them) is refused with ``ValueError``, as the
    card refuses it, rather than expanded into wrong descriptors."""
    parts = []
    for p, v0 in zip(stream.plans, stream.page_table[0].tolist()):
        if p.n == 0 or p.n_values < 2:
            continue
        esc = np.flatnonzero(p.flags)
        after = p.offsets[esc[-1] + 1:] if len(esc) else p.offsets
        more = (len(esc) == p.n_escapes
                and bool((unpack_at(p.words, after, p.n) == np.uint64((1 << p.n) - 1)).any()))
        if len(esc) != p.n_escapes or more:
            raise ValueError(
                f"a page's tokens do not follow its escapes: its payload length claims "
                f"{p.n_escapes} escaped values, its tokens mark {len(esc)}"
                f"{' and more' if more else ''}")
        parts.append(esc + (v0 + 1))  # token j is value j + 1
    return np.concatenate(parts).astype(np.int32) if parts else np.zeros(0, np.int32)


def expand_stream_ref(stream: PageStream) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The plain host expansion of a compact stream: ``(tok_off, nbits,
    anchor)``, each (n_blocks, STREAM_BLOCK) int32, byte for byte the arrays
    the JAX package's ``build_page_stream`` builds. Counted in
    ``stream.expand.host_values`` (positions, padding included)."""
    n_blocks, block = stream.shape
    pad = n_blocks * block
    W = stream.width
    off = np.zeros(pad, np.int64)
    nb = np.full(pad, W, np.int64)   # padding: W-bit anchors at bit 0
    an = np.ones(pad, np.int64)
    is_esc = np.zeros(pad, bool)
    is_esc[stream.escapes] = True
    for v0, cnt, base, tn, _ in stream.page_table.T.astype(np.int64):
        first = base + HEADER_BITS
        if tn == 0:  # raw mode: every value a W-bit anchor
            off[v0:v0 + cnt] = first + W * np.arange(cnt, dtype=np.int64)
            continue
        off[v0] = first
        if cnt > 1:
            # delta token j is value j + 1; an escaped one reads the raw value
            # after the marker
            esc = is_esc[v0 + 1:v0 + cnt]
            before = np.cumsum(esc) - esc
            off[v0 + 1:v0 + cnt] = (first + W + tn * np.arange(cnt - 1, dtype=np.int64)
                                    + W * before + tn * esc)
            nb[v0 + 1:v0 + cnt] = np.where(esc, W, tn)
            an[v0 + 1:v0 + cnt] = esc
    obs.count("stream.expand.host_values", pad)
    shape = (n_blocks, block)
    return (off.astype(np.int32).reshape(shape), nb.astype(np.int32).reshape(shape),
            an.astype(np.int32).reshape(shape))


@dataclass
class RefineAux:
    """Host-built segmentation of a :class:`PageStream` into record slices.

    A record's x values occupy one contiguous slice of the stream and its y
    values another (pages are record-aligned and interleave x,y per page).
    ``x_start``/``y_start``/``counts`` are the slice geometry kernel 2
    reduces over and the host uses to build survivor gather indices;
    ``valid`` is kernel 2's record operand, which gates the survivor mask
    (a caller may AND an attribute mask into it).
    """

    valid: np.ndarray      # (n_records,) bool — records with >= 1 value
    n_records: int
    x_start: np.ndarray    # (n_records,) int64 stream offset of x slice
    y_start: np.ndarray    # (n_records,) int64
    counts: np.ndarray     # (n_records,) int64 values per record (per axis)


def build_refine_aux(stream: PageStream, pairs, rec_vcounts) -> RefineAux:
    """Segment a stream built from interleaved x,y page pairs by record.

    ``pairs[i] = (r0, r1)``: the record range covered by the i-th x/y page
    pair (``stream.counts[2i]``/``[2i+1]`` are its value counts); records are
    indexed locally and contiguously across pairs. ``rec_vcounts[r]`` is the
    per-axis value count of record ``r``. Traced as the ``stream.aux`` span.
    """
    with (obs.span("stream.aux", cat="plan", records=len(rec_vcounts))
          if obs.enabled() else obs.NULL_SPAN):
        counts = np.ascontiguousarray(rec_vcounts, dtype=np.int64)
        n_rec = len(counts)
        x_start = np.zeros(n_rec, np.int64)
        y_start = np.zeros(n_rec, np.int64)
        off = 0
        for i, (r0, r1) in enumerate(pairs):
            c = counts[r0:r1]
            starts = np.cumsum(c) - c
            x_start[r0:r1] = off + starts
            off += int(stream.counts[2 * i])
            y_start[r0:r1] = off + starts
            off += int(stream.counts[2 * i + 1])
        if off != stream.n_values:
            raise ValueError(f"refine aux covers {off} values, stream has {stream.n_values}")
        return RefineAux(counts > 0, n_rec, x_start, y_start, counts)


@dataclass
class DeviceStream:
    """A :class:`PageStream` (and optionally its :class:`RefineAux`) as
    tensors on one device: the operands of the decode and refine kernels."""

    words32: torch.Tensor   # (n_words,) int32
    tok_off: torch.Tensor   # (n_blocks, STREAM_BLOCK) int32
    nbits: torch.Tensor     # (n_blocks, STREAM_BLOCK) int32
    anchor: torch.Tensor    # (n_blocks, STREAM_BLOCK) int32
    width: int
    n_values: int
    x_start: torch.Tensor | None = None   # (n_records,) int64
    y_start: torch.Tensor | None = None   # (n_records,) int64
    counts: torch.Tensor | None = None    # (n_records,) int64
    valid: torch.Tensor | None = None     # (n_records,) bool
    bad: torch.Tensor | None = None       # (1,) int32 on the card: pages whose
                                          # tokens do not follow their escapes
                                          # (None on the CPU, which raised)


def check_escapes(streams) -> None:
    """Raise ``ValueError`` if the card found a page of any of ``streams``
    whose tokens do not follow its escapes. Read after a transfer that
    already waited for the streams' kernels, it waits for nothing more."""
    bad = [ds.bad for ds in streams if ds.bad is not None]
    if not bad:
        return
    n = int((bad[0] if len(bad) == 1 else torch.stack(bad).sum()).item())
    if n:
        raise ValueError(f"{n} page(s) of the stream do not follow their escapes: "
                         "the payload lengths claim other escapes than the tokens mark")


def stream_from_numpy(stream: PageStream, aux: RefineAux | None = None, *,
                      device="cuda") -> DeviceStream:
    """Move a host-built stream (and refine aux) to ``device`` as tensors.

    On CUDA the compact stream is copied (each page's words into its place,
    zeros after the last page, then the page table); ``csrc/stream_expand.cu``
    finds the escapes in the words (span ``device.resolve_launch``, counter
    ``page.resolve.device_pages``) and writes the token descriptors (span
    ``device.expand_launch``) on the card. A page whose tokens do not follow
    its escapes is counted in ``DeviceStream.bad``, for
    :func:`check_escapes` after the caller's transfer. On CPU the plain host
    resolution and expansion are copied, and such a page raises here.
    """
    dev = torch_device(device)
    on_card = dev.type == "cuda"

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    with obs.span("device.h2d", cat="transfer", values=stream.n_values):
        if on_card:
            # a pageable copy a page: on the H100's host these beat one host
            # copy of the chunk into pinned memory and one DMA (CUDA
            # overlaps its staging with the transfer)
            words = torch.empty(stream.n_words, dtype=torch.int32, device=dev)
            w64, at = words.view(torch.int64), 0
            for w in stream.word_parts:
                w64[at:at + len(w)].copy_(torch.from_numpy(w.view(np.int64)))
                at += len(w)
            w64[at:].zero_()
            table = put(stream.page_table)
        else:
            words = put(stream.words32)
            desc = (put(stream.tok_off), put(stream.nbits), put(stream.anchor))
        if aux is not None:
            rec = (put(aux.x_start), put(aux.y_start), put(aux.counts),
                   put(aux.valid[:aux.n_records]))
    bad = None
    if on_card:
        pt = stream.page_table
        with obs.span("device.resolve_launch", cat="device", pages=pt.shape[1],
                      escapes=stream.n_escapes):
            escapes, bad = kernel.escape_resolve(words, table, stream.n_escapes,
                                                 stream.width)
            obs.count("page.resolve.device_pages", int(np.count_nonzero((pt[3] > 0)
                                                                        & (pt[1] > 1))))
        with obs.span("device.expand_launch", cat="device", values=stream.n_values,
                      escapes=stream.n_escapes):
            desc = kernel.expand_stream(table, escapes, stream.n_values, stream.width,
                                        stream.shape[0])
            obs.count("stream.expand.device_values", desc[0].numel())
    ds = DeviceStream(words, *desc, stream.width, stream.n_values, bad=bad)
    if aux is not None:
        ds.x_start, ds.y_start, ds.counts, ds.valid = rec
    return ds


def decode_stream_bits(ds: DeviceStream) -> torch.Tensor:
    """Decode a device stream: the W-bit patterns of every stream position
    (padding included), int32 for W = 32, int64 for W = 64."""
    with obs.span("device.decode_launch", cat="device",
                  values=ds.n_values, width=ds.width):
        if ds.words32.device.type == "cuda":
            return kernel.decode_stream(ds.words32, ds.tok_off, ds.nbits,
                                        ds.anchor, ds.width)
        return ref.decode_stream_ref(ds.words32, ds.tok_off, ds.nbits,
                                     ds.anchor, ds.width)


def decode_stream_device(stream: PageStream, *, device="cuda") -> torch.Tensor:
    """Decode a built stream, keeping the result on ``device``; on CUDA it
    waits for the card's escape check (:func:`check_escapes`)."""
    ds = stream_from_numpy(stream, device=device)
    bits = decode_stream_bits(ds)
    check_escapes([ds])
    return bits


def decode_page_stream(stream: PageStream, *, device="cuda") -> np.ndarray:
    """Decode a built stream; returns the concatenated values (float32 for
    W=32, float64 for W=64). Bit-identical to the host ``fp_delta_decode``."""
    n = stream.n_values
    dtype = np.float32 if stream.width == 32 else np.float64
    if n == 0:
        return np.zeros(0, dtype)
    bits = decode_stream_device(stream, device=device)
    return TorchCoords(bits[:n], np.dtype(dtype)).to_numpy()


def _plan_bits(p: FPDeltaPlan) -> int:
    """Packed payload bits a plan occupies in a page stream (spill word
    excluded — the single source of the launch-cap accounting)."""
    return (len(p.words) - 1) * 64


def decode_pages(plans, *, device="cuda") -> list[np.ndarray]:
    """Decode many host-resolved pages on ``device``; one array per plan.

    Pages are greedily packed into as few launches as the cap allows. A
    single page too large for any launch falls back to the host
    ``fp_delta_execute`` — same bits either way.
    """
    plans = list(plans)
    out: list[np.ndarray] = []

    def flush(chunk: list[FPDeltaPlan]) -> None:
        if not chunk:
            return
        with obs.span("device.decode_pages", cat="device", pages=len(chunk)):
            stream = build_page_stream(chunk)
            vals = decode_page_stream(stream, device=device)
        out.extend(np.split(vals, np.cumsum(stream.counts)[:-1]))

    chunk: list[FPDeltaPlan] = []
    bits = 0
    for p in plans:
        pbits = _plan_bits(p)
        if pbits > _MAX_LAUNCH_BITS:  # one giant page: host-decode it
            flush(chunk)
            chunk, bits = [], 0
            out.append(fp_delta_execute(p))
            continue
        if chunk and bits + pbits > _MAX_LAUNCH_BITS:
            flush(chunk)
            chunk, bits = [], 0
        chunk.append(p)
        bits += pbits
    flush(chunk)
    return out


def chunk_plan_pairs(plans, pairs):
    """Group x/y page-pair plans into fused launches under the cap.

    ``plans[2i]``/``plans[2i+1]`` are the x/y plans of pair ``i``;
    ``pairs[i] = (rec_lo, rec_hi)`` its record range. Yields ``("dev",
    plan_list, pair_list, (rec_lo, rec_hi))`` per launch chunk, or
    ``("host", (plan_x, plan_y), None, (rec_lo, rec_hi))`` for a pair whose
    packed payload alone exceeds the cap (the caller host-decodes it via
    ``fp_delta_execute`` — records never straddle pages, so chunk masks
    concatenate exactly). Lives next to :data:`_MAX_LAUNCH_BITS` so the cap
    accounting has a single owner (shared with :func:`decode_pages`).
    """
    cur_plans: list = []
    cur_pairs: list = []
    bits = 0
    for i, (r0, r1) in enumerate(pairs):
        px, py = plans[2 * i], plans[2 * i + 1]
        pbits = _plan_bits(px) + _plan_bits(py)
        if pbits > _MAX_LAUNCH_BITS:
            if cur_plans:
                yield ("dev", cur_plans, cur_pairs,
                       (cur_pairs[0][0], cur_pairs[-1][1]))
                cur_plans, cur_pairs, bits = [], [], 0
            yield ("host", (px, py), None, (r0, r1))
            continue
        if cur_plans and bits + pbits > _MAX_LAUNCH_BITS:
            yield ("dev", cur_plans, cur_pairs,
                   (cur_pairs[0][0], cur_pairs[-1][1]))
            cur_plans, cur_pairs, bits = [], [], 0
        cur_plans += [px, py]
        cur_pairs.append((r0, r1))
        bits += pbits
    if cur_plans:
        yield ("dev", cur_plans, cur_pairs, (cur_pairs[0][0], cur_pairs[-1][1]))


# ------------------------------------------------------ fused decode→refine
@dataclass
class RefineResult:
    """Fused-launch output: the decoded stream on the device + the host mask."""

    bits: torch.Tensor    # (n_pad,) int32/int64 tensor (empty when skipped)
    keep: np.ndarray      # (n_records,) bool — the only mandatory transfer


def decode_refine_stream(stream: PageStream, aux: RefineAux, bbox, *,
                         device="cuda") -> RefineResult:
    """Fused decode→bbox-refine over one built page stream.

    Decodes the stream on ``device``, reduces per-record [min, max] of x
    and y in order-key space, and tests each record against ``bbox``
    (``aux.valid`` gates the mask, so a caller can AND an attribute mask
    into it). Only the record mask crosses back to the host here; pull
    surviving coordinates afterwards with :func:`gather_stream_values`. The
    surviving record set is **bit-identical** to the host refine
    (NaN-propagating ``minimum.reduceat`` + float compares).
    """
    dtype = np.float32 if stream.width == 32 else np.float64
    qkeys = bbox_query_keys(bbox, dtype)
    if qkeys is None:  # NaN bound: the host compare keeps nothing, no launch
        empty = torch.zeros(0, dtype=torch.int32 if stream.width == 32 else torch.int64,
                            device=torch_device(device))
        return RefineResult(empty, np.zeros(aux.n_records, bool))
    ds = stream_from_numpy(stream, aux, device=device)
    bits = decode_stream_bits(ds)
    with obs.span("device.refine_launch", cat="device",
                  values=stream.n_values, records=aux.n_records,
                  width=stream.width):
        keep, _ = segminmax_refine(bits, ds.x_start, ds.y_start, ds.counts,
                                   ds.valid, keys64(qkeys), stream.width)
        keep = keep.cpu().numpy()
    check_escapes([ds])
    return RefineResult(bits, keep)


# ------------------------------------------------- multi-query refinement
# The query server's form of the fused chain (repro_torch.serve.
# query_scheduler): one decode and one per-record min/max launch answer Q
# bboxes at once. Kernel 2 already writes every record's (x, y) min/max key
# bits, so the query axis is a compare over those keys; the key stack stays
# on the device, where a decoded-row-group cache answers later waves with
# the compare alone (refine_minmax_multi).


@dataclass
class MultiRefineResult:
    """Fused multi-query launch output.

    ``bits`` (the decoded stream), ``mm`` (the (R, 4) per-record min/max key
    bits) and ``valid`` (the (R,) record-validity operand) stay on the
    device and can be cached; ``keep`` is the (Q, R) host survivor matrix.
    """

    bits: torch.Tensor
    mm: torch.Tensor
    valid: torch.Tensor
    keep: np.ndarray


def decode_refine_stream_multi(stream: PageStream, aux: RefineAux, qkeys,
                               qvalid, *, device="cuda") -> MultiRefineResult:
    """Fused decode→refine answering Q stacked bbox queries.

    ``qkeys``/``qvalid`` come from
    :func:`repro_torch.kernels.minmax.stack_bbox_query_keys`. Each query's
    survivor row is bit-identical to a solo :func:`decode_refine_stream`
    over the same stream; invalid (NaN-bound) queries get all-False rows.
    Kernel 2 runs with any one query's keys (its own mask is not used here):
    the per-record keys it writes do not depend on them.
    """
    qvalid = np.asarray(qvalid, bool)
    ds = stream_from_numpy(stream, aux, device=device)
    first = np.flatnonzero(qvalid)
    if len(first):
        k = keys64(qkeys[first[0]])
    else:
        neg, pos = inf_keys64(stream.width)
        k = (neg, pos, neg, pos)
    with obs.span("device.refine_multi_launch", cat="device",
                  values=stream.n_values, records=aux.n_records,
                  queries=len(qkeys), width=stream.width):
        bits = decode_stream_bits(ds)
        _, mm = segminmax_refine(bits, ds.x_start, ds.y_start, ds.counts,
                                 ds.valid, k, stream.width)
        keep = keep_from_minmax(mm, ds.valid, qkeys, qvalid,
                                stream.width).cpu().numpy()
    check_escapes([ds])
    return MultiRefineResult(bits, mm, ds.valid, keep)


def refine_minmax_multi(mm, valid, qkeys, qvalid, *, width: int) -> np.ndarray:
    """Re-test a cached per-record min/max key stack against Q new bboxes.

    The cache-hit half of the query server: no decode and no scan, only the
    compare of the fused miss path, so hit and miss survivor rows are
    bit-identical. Returns (Q, R) bool.
    """
    with obs.span("device.refine_cached", cat="device",
                  records=int(mm.shape[0]), queries=len(qkeys), width=width):
        return keep_from_minmax(mm, valid, qkeys, qvalid, width).cpu().numpy()


def ragged_ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenate ``arange(s, s + c)`` for each (start, count) pair."""
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    rep_start = np.repeat(np.asarray(starts, np.int64), counts)
    excl = np.cumsum(counts) - counts
    return rep_start + (np.arange(total, dtype=np.int64) - np.repeat(excl, counts))


def gather_stream_values(bits: torch.Tensor, idx: np.ndarray, dtype, *,
                         keep_on_device: bool = False):
    """Compact survivor values out of a decoded stream by position.

    ``idx`` (host int array) selects stream positions; the gather runs on
    the stream's device, so the host transfer is bounded by the survivor
    count (never the full column). Returns a numpy array of ``dtype`` — or
    a :class:`~repro_torch.core.columnar.TorchCoords` when ``keep_on_device``
    (zero host transfer).
    """
    dtype = np.dtype(dtype)
    with obs.span("device.gather", cat="transfer", values=len(idx),
                  on_device=bool(keep_on_device)):
        sel = torch.from_numpy(np.ascontiguousarray(idx, np.int64)).to(bits.device)
        coords = TorchCoords(bits.index_select(0, sel), dtype)
        if not keep_on_device:
            coords = coords.to_numpy()
    return coords

