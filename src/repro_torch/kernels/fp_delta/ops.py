"""The miniblock codec; page-stream decode, fused decode→refine, and
survivor gather.

Miniblock codec (:func:`encode`, :func:`decode`, :func:`to_bytes`,
:func:`from_bytes`, :func:`compress_array`, :func:`decompress_array`):
lossless 32-bit compression of arbitrary-length float32/int32 arrays in
self-contained blocks of ``MINIBLOCK`` values (format in :mod:`.ref`). The
input is padded with its last element (zero deltas cost nothing); the dense
device stream compacts on the host into the ``FPD2`` byte format.

Page stream: batched device execution of host-resolved ``FPDeltaPlan``s (the
paper-exact page format of :mod:`repro_torch.core.fp_delta`), consumed by
``SpatialParquetReader.read_columnar``. The host has done the sequential
part — escape resolution — so many pages concatenate into one flat value
stream (:func:`build_page_stream`): per-value token bit offsets, token
widths, and anchor flags. One decode launch covers a whole chunk of a row
group. :func:`decode_refine_stream` chains the decode with the per-record
order-key min/max and the bbox survivor test of
:mod:`repro_torch.kernels.minmax`, so only the record mask and then the
surviving values (:func:`gather_stream_values`) leave the device.

Operands are built as numpy arrays on the host (byte for byte the arrays
the JAX package builds) and moved to the device once by
:func:`stream_from_numpy`. Every device function follows the device of its
tensors: CUDA tensors launch the kernels, CPU tensors run the plain versions.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import torch_device
from repro_torch.core.columnar import TorchCoords
from repro_torch.core.fp_delta import HEADER_BITS, FPDeltaPlan, fp_delta_execute
from repro_torch.kernels.minmax import (
    bbox_query_keys,
    inf_keys64,
    keep_from_minmax_ref,
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
    """Many pages concatenated into one device-decodable value stream."""

    words32: np.ndarray   # (n_words,) int32, n_words % 128 == 0, >= 2 spill words
    tok_off: np.ndarray   # (n_blocks, STREAM_BLOCK) int32 token bit offsets
    nbits: np.ndarray     # (n_blocks, STREAM_BLOCK) int32 token widths [1, 64]
    anchor: np.ndarray    # (n_blocks, STREAM_BLOCK) int32 0/1 (padding = 1)
    width: int            # 32 or 64 (uniform across the stream)
    counts: tuple[int, ...]  # per-page value counts (output split points)

    @property
    def n_values(self) -> int:
        return sum(self.counts)


def build_page_stream(plans) -> PageStream:
    """Concatenate resolved plans into one :class:`PageStream`.

    Page payloads are placed word-aligned in a shared uint32 buffer; each
    value becomes either an *anchor* (page first value, escaped raw value,
    or any raw-mode value — token width W, starts a segment) or an inline
    n-bit delta token. Total payload must stay under ``_MAX_LAUNCH_BITS``
    (use :func:`decode_pages`, which chunks automatically).
    """
    plans = list(plans)
    widths = {p.width for p in plans if p.n_values}
    if len(widths) > 1:
        raise ValueError(f"mixed widths in one page stream: {sorted(widths)}")
    width = widths.pop() if widths else 32

    word_base = 0  # uint64 words placed so far
    wparts: list[np.ndarray] = []
    offp: list[np.ndarray] = []
    nbp: list[np.ndarray] = []
    anchp: list[np.ndarray] = []
    counts: list[int] = []
    for p in plans:
        counts.append(p.n_values)
        if p.n_values == 0:
            continue
        base_bit = word_base * 64
        w = p.words[:-1]  # drop the all-zero spill word; re-guarded globally
        cnt, W = p.n_values, p.width
        if p.n == 0:  # raw mode: every value a W-bit anchor
            off = base_bit + HEADER_BITS + W * np.arange(cnt, dtype=np.int64)
            nb = np.full(cnt, W, np.int64)
            an = np.ones(cnt, np.int64)
        else:
            off = np.empty(cnt, np.int64)
            nb = np.empty(cnt, np.int64)
            an = np.zeros(cnt, np.int64)
            off[0], nb[0], an[0] = base_bit + HEADER_BITS, W, 1
            if cnt > 1:
                # escaped deltas read the raw value after the marker
                off[1:] = base_bit + np.where(p.flags, p.offsets + p.n, p.offsets)
                nb[1:] = np.where(p.flags, W, p.n)
                an[1:] = p.flags
        offp.append(off)
        nbp.append(nb)
        anchp.append(an)
        word_base += len(w)
        wparts.append(w)

    total_bits = word_base * 64
    if total_bits > _MAX_LAUNCH_BITS:
        raise ValueError(
            f"page stream of {total_bits} bits exceeds the per-launch cap "
            f"of {_MAX_LAUNCH_BITS}; use decode_pages, which chunks pages "
            "across launches and host-decodes oversized single pages")

    words64 = np.concatenate(wparts) if wparts else np.zeros(0, np.uint64)
    # LE uint32 view keeps the bit layout: stream bit b = bit b%32 of word b//32
    words32 = np.ascontiguousarray(words64).view("<u4")
    nw = _pow2_bucket(_round_up(len(words32) + 2, 128), 128)
    wbuf = np.zeros(nw, np.uint32)
    wbuf[: len(words32)] = words32

    n = int(sum(counts))
    n_blocks = _pow2_bucket(-(-max(n, 1) // STREAM_BLOCK), 1)
    pad = n_blocks * STREAM_BLOCK
    off_a = np.zeros(pad, np.int64)
    nb_a = np.full(pad, width, np.int64)   # padding: W-bit anchors at bit 0
    an_a = np.ones(pad, np.int64)
    if n:
        off_a[:n] = np.concatenate(offp)
        nb_a[:n] = np.concatenate(nbp)
        an_a[:n] = np.concatenate(anchp)
    shape = (n_blocks, STREAM_BLOCK)
    return PageStream(
        wbuf.view(np.int32),
        off_a.astype(np.int32).reshape(shape),
        nb_a.astype(np.int32).reshape(shape),
        an_a.astype(np.int32).reshape(shape),
        width, tuple(counts),
    )


@dataclass
class RefineAux:
    """Host-built segmentation of a :class:`PageStream` into record slices.

    A record's x values occupy one contiguous slice of the stream and its y
    values another (pages are record-aligned and interleave x,y per page).
    ``seg_flag`` marks slice starts (padding tail flagged, mirroring the
    anchor-padding rule of the decode); ``end_pos[r] = (x_end, y_end)`` is
    the record's last value on each axis. ``x_start``/``y_start``/``counts``
    are the slice geometry the refine kernel reduces over and the host uses
    to build survivor gather indices.
    """

    seg_flag: np.ndarray   # (n_blocks, STREAM_BLOCK) int32, 1 at slice starts
    end_pos: np.ndarray    # (n_rec_pad, 2) int32
    valid: np.ndarray      # (n_rec_pad,) bool — records with >= 1 value
    n_records: int
    x_start: np.ndarray    # (n_records,) int64 stream offset of x slice
    y_start: np.ndarray    # (n_records,) int64
    counts: np.ndarray     # (n_records,) int64 values per record (per axis)


def build_refine_aux(stream: PageStream, pairs, rec_vcounts) -> RefineAux:
    """Segment a stream built from interleaved x,y page pairs by record.

    ``pairs[i] = (r0, r1)``: the record range covered by the i-th x/y page
    pair (``stream.counts[2i]``/``[2i+1]`` are its value counts); records are
    indexed locally and contiguously across pairs. ``rec_vcounts[r]`` is the
    per-axis value count of record ``r``.
    """
    counts = np.ascontiguousarray(rec_vcounts, dtype=np.int64)
    n_rec = len(counts)
    total = stream.n_values
    n_pad_vals = stream.tok_off.size
    flag = np.zeros(n_pad_vals, np.int32)
    flag[total:] = 1  # isolate padding into its own throwaway segments
    x_start = np.zeros(n_rec, np.int64)
    y_start = np.zeros(n_rec, np.int64)
    off = 0
    for i, (r0, r1) in enumerate(pairs):
        c = counts[r0:r1]
        nz = c > 0
        starts = off + np.cumsum(c) - c
        x_start[r0:r1] = starts
        flag[starts[nz]] = 1
        off += int(stream.counts[2 * i])
        starts = off + np.cumsum(c) - c
        y_start[r0:r1] = starts
        flag[starts[nz]] = 1
        off += int(stream.counts[2 * i + 1])
    if off != total:
        raise ValueError(f"refine aux covers {off} values, stream has {total}")
    n_rec_pad = _pow2_bucket(max(n_rec, 1), 8)
    end = np.zeros((n_rec_pad, 2), np.int32)
    end[:n_rec, 0] = x_start + np.maximum(counts - 1, 0)
    end[:n_rec, 1] = y_start + np.maximum(counts - 1, 0)
    valid = np.zeros(n_rec_pad, bool)
    valid[:n_rec] = counts > 0
    return RefineAux(flag.reshape(stream.tok_off.shape), end, valid, n_rec,
                     x_start, y_start, counts)


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


def stream_from_numpy(stream: PageStream, aux: RefineAux | None = None, *,
                      device="cuda") -> DeviceStream:
    """Move a host-built stream (and refine aux) to ``device`` as tensors."""
    dev = torch_device(device)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    with obs.span("device.h2d", cat="transfer", values=stream.n_values):
        ds = DeviceStream(put(stream.words32), put(stream.tok_off),
                          put(stream.nbits), put(stream.anchor),
                          stream.width, stream.n_values)
        if aux is not None:
            n = aux.n_records
            ds.x_start, ds.y_start = put(aux.x_start), put(aux.y_start)
            ds.counts, ds.valid = put(aux.counts), put(aux.valid[:n])
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
    """Decode a built stream, keeping the result on ``device``."""
    return decode_stream_bits(stream_from_numpy(stream, device=device))


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
        keep = keep_from_minmax_ref(mm, ds.valid, qkeys, qvalid,
                                    stream.width).cpu().numpy()
    return MultiRefineResult(bits, mm, ds.valid, keep)


def refine_minmax_multi(mm, valid, qkeys, qvalid, *, width: int) -> np.ndarray:
    """Re-test a cached per-record min/max key stack against Q new bboxes.

    The cache-hit half of the query server: no decode and no scan, only the
    compare of the fused miss path, so hit and miss survivor rows are
    bit-identical. Returns (Q, R) bool.
    """
    with obs.span("device.refine_cached", cat="device",
                  records=int(mm.shape[0]), queries=len(qkeys), width=width):
        return keep_from_minmax_ref(mm, valid, qkeys, qvalid,
                                    width).cpu().numpy()


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
