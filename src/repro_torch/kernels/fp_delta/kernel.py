"""Wrappers of the FP-delta CUDA kernels: the page-stream decode
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
