"""Plain PyTorch version of the FP-delta page-stream decode kernel.

A page stream is many FP-delta pages (the paper-exact format of
:mod:`repro_torch.core.fp_delta`) concatenated into one value stream. The
host resolves escapes into plans; every value is then either an *anchor*
(a raw W-bit pattern: a page's first value, an escaped value, or any value
of a raw page) or an inline n-bit zigzag delta. Decode = fixed-width gather
+ un-zigzag + segmented cumsum over the anchor-delimited segments.

The arithmetic is 64-bit two's complement throughout, which is what the
reference's uint32 limb pairs compute. CPU torch has no shifts or compares
on ``uint32``, so everything here runs in int64 with explicit masks (int64
``>>`` is arithmetic: a logical shift masks afterwards); sums mod 2^64 rely
on int64 wrap-around.
"""

from __future__ import annotations

import torch

STREAM_BLOCK = 1024  # values per block of the decode kernel; the stream's padding unit

_M32 = 0xFFFFFFFF
_I64_MAX = (1 << 63) - 1


def gather_tokens(words32: torch.Tensor, offs: torch.Tensor, nbits: torch.Tensor):
    """Token bits ``[offs, offs + nbits)`` of the LE word stream, as int64
    holding the 64-bit pattern. ``words32`` carries >= 2 spill words."""
    words = words32.to(torch.int64) & _M32
    w0i = offs >> 5
    w0, w1, w2 = words[w0i], words[w0i + 1], words[w0i + 2]
    s = offs & 31
    # for s == 0, w << 32 has no low bits, so the mask drops it
    lo = ((w0 >> s) | (w1 << (32 - s))) & _M32
    hi = ((w1 >> s) | (w2 << (32 - s))) & _M32
    nlo = nbits.clamp(1, 32)
    nhi = (nbits - 32).clamp(0, 32)
    lo = lo & ((1 << nlo) - 1)
    hi = hi & ((1 << nhi) - 1)
    return (hi << 32) | lo


def unzigzag64(z: torch.Tensor) -> torch.Tensor:
    """64-bit unzigzag ``(z >>> 1) ^ -(z & 1)`` on int64 patterns."""
    return ((z >> 1) & _I64_MAX) ^ -(z & 1)


def segmented_sum(vals: torch.Tensor, anchor: torch.Tensor) -> torch.Tensor:
    """Inclusive sum mod 2^64 restarting at every anchor (anchors keep their
    own value); values before the first anchor sum from zero."""
    total = torch.cumsum(vals, 0)
    before = total - vals  # exclusive prefix
    seg = torch.cumsum(anchor.to(torch.int64), 0)
    # the prefix just before each segment's anchor; segment 0 has none
    start = torch.zeros(int(anchor.sum()) + 1, dtype=torch.int64, device=vals.device)
    start[1:] = before[anchor]
    return total - start[seg]


def decode_stream_ref(words32, tok_off, nbits, anchor, width: int) -> torch.Tensor:
    """Plain version of :func:`repro_torch.kernels.fp_delta.kernel.decode_stream`.

    Returns the decoded W-bit patterns of every stream position (padding
    included): int32 for ``width == 32``, int64 for ``width == 64``.
    """
    offs = tok_off.reshape(-1).to(torch.int64)
    anc = anchor.reshape(-1) != 0
    tok = gather_tokens(words32, offs, nbits.reshape(-1).to(torch.int64))
    vals = torch.where(anc, tok, unzigzag64(tok))
    out = segmented_sum(vals, anc)
    if width == 64:
        return out
    lo = out & _M32
    return (lo - ((lo >> 31) << 32)).to(torch.int32)
