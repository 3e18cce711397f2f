"""Wrappers of the FP-delta CUDA kernels: the page stream's escape
resolution and descriptor expansion (``csrc/stream_expand.cu``), the
page-stream decode
(``csrc/fp_delta_decode.cu``) and the miniblock codec (``csrc/miniblock.cu``).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs (and scratch) with ``torch.empty``, launches on the current stream,
raises on a CUDA error, and counts its launches in ``<wrapper>.launches``
(:func:`.._build.bump`). The plain versions are in :mod:`.ref`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import MAX_EXC, MINIBLOCK, STREAM_BLOCK

_P = ctypes.c_void_p


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, dev: torch.device, shape) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def escape_resolve(words32, page_table, n_escapes: int, width: int):
    """Find every page's reset markers in a page stream's words on the card.

    ``words32``: (n_words,) int32, the stream's packed words (each page from
    its base bit, zeros after the last page), n_words even and the buffer
    8-byte aligned; ``page_table``: (5, n_pages) int32 as for
    :func:`expand_stream`, its fifth row the running sum of the pages' escape
    counts (their payload lengths'); ``n_escapes``: the total. Returns
    ``(escapes, bad)``: (n_escapes,) int32 ascending stream positions of the
    escaped values, equal to :func:`.ops.escape_resolve_ref`, and a (1,)
    int32 count of pages whose tokens do not mark exactly the escapes the
    table gives them. Such a page's slots hold its first positions instead,
    so that the expansion and the decode stay inside the buffer; the caller
    reads ``bad`` after a transfer it waits for anyway.
    """
    dev = words32.device
    if dev.type != "cuda":
        raise ValueError("escape_resolve kernel needs CUDA tensors")
    if width not in (32, 64):
        raise ValueError(f"width must be 32 or 64, got {width}")
    if words32.dim() != 1 or words32.numel() % 2 or words32.numel() < 2:
        raise ValueError("words32 must be 1-D with an even number (>= 2) of words")
    if page_table.dim() != 2 or page_table.shape[0] != 5:
        raise ValueError(f"page_table must be (5, n_pages), got {tuple(page_table.shape)}")
    n_pages = page_table.shape[1]
    _check(words32, "words32", torch.int32, dev, words32.shape)
    _check(page_table, "page_table", torch.int32, dev, (5, n_pages))
    if words32.data_ptr() % 8:
        raise ValueError("words32 must be 8-byte aligned")
    if not 0 <= n_escapes < 2 ** 31:
        raise ValueError(f"{n_escapes} escapes exceed int32 positions")
    escapes = torch.empty(n_escapes, dtype=torch.int32, device=dev)
    bad = torch.empty(1, dtype=torch.int32, device=dev)
    fn = _build.entry("stream_expand", "sx_resolve_escapes",
                      [_P, ctypes.c_longlong, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       _P, _P, _P])
    err = fn(words32.data_ptr(), words32.numel() // 2, page_table.data_ptr(), n_pages,
             n_escapes, width, escapes.data_ptr(), bad.data_ptr(), _stream(dev))
    _build.check(_build.load("stream_expand"), "sx", err, "escape_resolve launch")
    _build.bump(escape_resolve)
    return escapes, bad


escape_resolve.launches = 0


def expand_stream(page_table, escapes, n_values: int, width: int, n_blocks: int):
    """Expand a compact page stream into the decode's token descriptors on
    the card.

    ``page_table``: (5, n_pages) int32, rows value start, value count, base
    bit, token width n (0: raw mode), first escape index, one column a page
    that holds values, in stream order; ``escapes``: (n_escapes,) int32
    ascending stream positions of escaped values. Returns ``(tok_off, nbits,
    anchor)``, each (n_blocks, STREAM_BLOCK) int32, equal to
    :func:`.ops.expand_stream_ref` bit for bit, padding tail included.
    """
    dev = page_table.device
    if dev.type != "cuda":
        raise ValueError("expand_stream kernel needs CUDA tensors")
    if width not in (32, 64):
        raise ValueError(f"width must be 32 or 64, got {width}")
    if page_table.dim() != 2 or page_table.shape[0] != 5:
        raise ValueError(f"page_table must be (5, n_pages), got {tuple(page_table.shape)}")
    n_pages = page_table.shape[1]
    _check(page_table, "page_table", torch.int32, dev, (5, n_pages))
    _check(escapes, "escapes", torch.int32, dev, (escapes.numel(),))
    if n_blocks < 1 or n_values < 0 or n_values > n_blocks * STREAM_BLOCK:
        raise ValueError(f"{n_values} values do not fit {n_blocks} blocks")
    if (n_pages == 0) != (n_values == 0):
        raise ValueError(f"{n_pages} pages for {n_values} values")
    if n_blocks * STREAM_BLOCK >= 2 ** 31:
        raise ValueError(f"{n_blocks} blocks exceed int32 positions")
    outs = tuple(torch.empty((n_blocks, STREAM_BLOCK), dtype=torch.int32, device=dev)
                 for _ in range(3))
    fn = _build.entry("stream_expand", "sx_expand_stream",
                      [_P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, _P, _P, _P, _P])
    err = fn(page_table.data_ptr(), n_pages, escapes.data_ptr(), escapes.numel(), n_values,
             width, n_blocks, *(t.data_ptr() for t in outs), _stream(dev))
    _build.check(_build.load("stream_expand"), "sx", err, "expand_stream launch")
    _build.bump(expand_stream)
    return outs


expand_stream.launches = 0


def decode_stream(words32, tok_off, nbits, anchor, width: int) -> torch.Tensor:
    """Decode a page stream on the card.

    ``words32``: (n_words,) int32, >= 2 spill words after the last token;
    ``tok_off``/``nbits``/``anchor``: (n_blocks, STREAM_BLOCK) int32 (the
    padding tail must be anchors). Returns the W-bit patterns flattened to
    (n_blocks * STREAM_BLOCK,): int32 for ``width == 32``, int64 for 64.
    """
    dev = words32.device
    if dev.type != "cuda":
        raise ValueError("decode_stream kernel needs CUDA tensors")
    if width not in (32, 64):
        raise ValueError(f"width must be 32 or 64, got {width}")
    if words32.dim() != 1 or words32.shape[0] < 3:
        raise ValueError("words32 must be 1-D with >= 3 words")
    shape = tok_off.shape
    if len(shape) != 2 or shape[1] != STREAM_BLOCK:
        raise ValueError(f"tok_off must be (n_blocks, {STREAM_BLOCK}), got {tuple(shape)}")
    _check(words32, "words32", torch.int32, dev, words32.shape)
    for t, name in ((tok_off, "tok_off"), (nbits, "nbits"), (anchor, "anchor")):
        _check(t, name, torch.int32, dev, shape)
    # the kernel copies operand rows with the bulk-copy engine (16-byte aligned)
    tok_off, nbits, anchor = (t if t.data_ptr() % 16 == 0 else t.clone()
                              for t in (tok_off, nbits, anchor))
    n_blocks = shape[0]
    out = torch.empty(n_blocks * STREAM_BLOCK,
                      dtype=torch.int32 if width == 32 else torch.int64, device=dev)
    words = _build.entry("fp_delta_decode", "fpd_scratch_words", [ctypes.c_int],
                         ctypes.c_longlong)
    # the tile ticket and statuses, zeroed by the entry point on this stream
    scratch = torch.empty(words(n_blocks), dtype=torch.int64, device=dev)
    fn = _build.entry("fp_delta_decode", "fpd_decode_stream",
                      [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P, _P])
    err = fn(words32.data_ptr(), tok_off.data_ptr(), nbits.data_ptr(),
             anchor.data_ptr(), n_blocks, width, scratch.data_ptr(), out.data_ptr(),
             _stream(dev))
    _build.check(_build.load("fp_delta_decode"), "fpd", err, "decode_stream launch")
    _build.bump(decode_stream)
    return out


decode_stream.launches = 0


def encode_blocks(x: torch.Tensor):
    """Miniblock encode on the card.

    ``x``: (n_blocks, MINIBLOCK) float32, contiguous, 16-byte aligned.
    Returns int32 ``(packed (n, MINIBLOCK), widths (n,), anchors (n,),
    exc_idx (n, MAX_EXC), exc_val (n, MAX_EXC), exc_count (n,))``, equal to
    :func:`.ref.encode_blocks_ref` on every input.
    """
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("encode_blocks kernel needs CUDA tensors")
    if x.dim() != 2:
        raise ValueError(f"x must be (n_blocks, {MINIBLOCK}), got {tuple(x.shape)}")
    n = x.shape[0]
    _check(x, "x", torch.float32, dev, (n, MINIBLOCK))
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    if n >= 2 ** 31:
        raise ValueError(f"{n} blocks exceed the grid's 2^31 - 1")
    i32 = dict(dtype=torch.int32, device=dev)
    outs = (torch.empty((n, MINIBLOCK), **i32), torch.empty(n, **i32), torch.empty(n, **i32),
            torch.empty((n, MAX_EXC), **i32), torch.empty((n, MAX_EXC), **i32),
            torch.empty(n, **i32))
    fn = _build.entry("miniblock", "mb_encode_blocks", [_P, ctypes.c_int] + [_P] * 7)
    err = fn(x.data_ptr(), n, *(t.data_ptr() for t in outs), _stream(dev))
    _build.check(_build.load("miniblock"), "mb", err, "encode_blocks launch")
    _build.bump(encode_blocks)
    return outs


encode_blocks.launches = 0


def decode_blocks(packed, widths, anchors, exc_idx, exc_val, exc_count) -> torch.Tensor:
    """Miniblock decode on the card -> (n_blocks, MINIBLOCK) float32.

    Takes the six int32 arrays of :func:`encode_blocks`; ``packed``,
    ``exc_idx`` and ``exc_val`` must be 16-byte aligned (the kernel copies
    their rows with the bulk-copy engine). The result equals
    :func:`.ref.decode_blocks_ref` bit for bit on every input, streams that
    encode never writes included: live exception slots (``slot <
    exc_count``, position in ``[0, MINIBLOCK)``) that repeat a position sum
    their values mod 2^32, as the reference's ``inject_exceptions`` does,
    and a width outside the format unpacks as zeros.
    """
    dev = packed.device
    if dev.type != "cuda":
        raise ValueError("decode_blocks kernel needs CUDA tensors")
    if packed.dim() != 2:
        raise ValueError(f"packed must be (n_blocks, {MINIBLOCK}), got {tuple(packed.shape)}")
    n = packed.shape[0]
    for t, name, shape in ((packed, "packed", (n, MINIBLOCK)), (widths, "widths", (n,)),
                           (anchors, "anchors", (n,)), (exc_idx, "exc_idx", (n, MAX_EXC)),
                           (exc_val, "exc_val", (n, MAX_EXC)), (exc_count, "exc_count", (n,))):
        _check(t, name, torch.int32, dev, shape)
    for t, name in ((packed, "packed"), (exc_idx, "exc_idx"), (exc_val, "exc_val")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if n >= 2 ** 31:
        raise ValueError(f"{n} blocks exceed the grid's 2^31 - 1")
    out = torch.empty((n, MINIBLOCK), dtype=torch.float32, device=dev)
    fn = _build.entry("miniblock", "mb_decode_blocks", [_P] * 6 + [ctypes.c_int, _P, _P])
    err = fn(packed.data_ptr(), widths.data_ptr(), anchors.data_ptr(), exc_idx.data_ptr(),
             exc_val.data_ptr(), exc_count.data_ptr(), n, out.data_ptr(), _stream(dev))
    _build.check(_build.load("miniblock"), "mb", err, "decode_blocks launch")
    _build.bump(decode_blocks)
    return out


decode_blocks.launches = 0
