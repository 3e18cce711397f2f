"""Wrapper of the page-stream decode CUDA kernel (``csrc/fp_delta_decode.cu``).

The wrapper checks device, dtype, shape and contiguity, allocates the output
and the per-block scratch with ``torch.empty``, launches on the current
stream, raises on a CUDA error, and counts launches in ``decode_stream.launches``.
The plain version is :func:`.ref.decode_stream_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import STREAM_BLOCK

_P = ctypes.c_void_p


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
    for t, name in ((words32, "words32"), (tok_off, "tok_off"),
                    (nbits, "nbits"), (anchor, "anchor")):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "words32" and t.shape != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != tok_off shape {tuple(shape)}")
    n_blocks = shape[0]
    out = torch.empty(n_blocks * STREAM_BLOCK,
                      dtype=torch.int32 if width == 32 else torch.int64, device=dev)
    sum_v = torch.empty(n_blocks, dtype=torch.int64, device=dev)
    sum_f = torch.empty(n_blocks, dtype=torch.int32, device=dev)
    carry = torch.empty(n_blocks, dtype=torch.int64, device=dev)
    lib = _build.load("fp_delta_decode")
    fn = lib.fpd_decode_stream
    fn.argtypes = [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P]
    fn.restype = ctypes.c_int
    err = fn(words32.data_ptr(), tok_off.data_ptr(), nbits.data_ptr(),
             anchor.data_ptr(), n_blocks, width, sum_v.data_ptr(),
             sum_f.data_ptr(), carry.data_ptr(), out.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "fpd", err, "decode_stream launch")
    decode_stream.launches += 1
    return out


decode_stream.launches = 0
