"""Plain PyTorch versions of the FP-delta kernels: the miniblock codec and
the page-stream decode.

Miniblock codec. A float32 stream is split into miniblocks of
``MINIBLOCK`` values. Each block is self-contained: a raw int32 *anchor*
(its first value), a width ``w`` in ``{0} | WIDTHS``, its zigzag deltas
(``delta[0] = 0``) packed LSB-first at ``w`` bits into ``MINIBLOCK*w/32``
words, and up to ``MAX_EXC`` *exceptions*: (position, full zigzag) pairs
for deltas wider than ``w`` bits. ``w`` minimizes ``MINIBLOCK*w +
EXC_BITS*n_over(w)`` subject to ``n_over(w) <= MAX_EXC``; ties keep the
smaller width. The payload keeps the low ``w`` bits of an exception's
zigzag; decode overwrites them.

Page stream. A page stream is many FP-delta pages (the paper-exact format of
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

MINIBLOCK = 1024
WIDTHS = (1, 2, 3, 4, 6, 8, 10, 12, 16, 20, 24, 32)
MAX_EXC = 64          # exception capacity per block
EXC_BITS = 16 + 32    # stored cost of one exception (position + raw zigzag)

_M32 = 0xFFFFFFFF
_I64_MAX = (1 << 63) - 1


# ------------------------------------------------------------ miniblock codec
def _to_i32(u: torch.Tensor) -> torch.Tensor:
    """int64 holding a 32-bit pattern -> int32 with the same bits."""
    u = u & _M32
    return (u - ((u >> 31) << 32)).to(torch.int32)


def significant_bits(z: torch.Tensor) -> torch.Tensor:
    """Bits needed for each value of ``z`` (int64 in [0, 2^32)); 0 for 0."""
    out = torch.zeros_like(z)
    v = z
    for s in (16, 8, 4, 2, 1):
        big = v >= (1 << s)
        out = out + big * s
        v = torch.where(big, v >> s, v)
    return out + (z != 0)


def choose_width(nbits: torch.Tensor) -> torch.Tensor:
    """(n, M) bit lengths -> (n,) int64 widths: the ascending scan over
    ``(0,) + WIDTHS[:-1]`` from w = 32, strict improvement of the cost,
    ``n_over <= MAX_EXC``."""
    m = nbits.shape[-1]
    best_w = torch.full(nbits.shape[:-1], 32, dtype=torch.int64, device=nbits.device)
    best_cost = torch.full_like(best_w, m * 32)
    for w in (0,) + WIDTHS[:-1]:
        n_over = (nbits > w).sum(-1)
        cost = m * w + EXC_BITS * n_over
        ok = (n_over <= MAX_EXC) & (cost < best_cost)
        best_w = torch.where(ok, w, best_w)
        best_cost = torch.where(ok, cost, best_cost)
    return best_w


def _stream_geometry(widths: torch.Tensor, m: int):
    """Per value t of each block: word index ``t*w // 32``, shift
    ``t*w % 32`` and the value mask, at the block's width ``w``."""
    w = widths.to(torch.int64)[:, None]
    off = torch.arange(m, dtype=torch.int64, device=widths.device)[None, :] * w
    return off >> 5, off & 31, (1 << w) - 1, w


def encode_blocks_ref(x: torch.Tensor):
    """Plain version of :func:`repro_torch.kernels.fp_delta.kernel.encode_blocks`.

    ``x``: (n_blocks, MINIBLOCK) float32 (or int32 bit patterns). Returns
    int32 ``(packed (n, M), widths (n,), anchors (n,), exc_idx (n, E),
    exc_val (n, E), exc_count (n,))``; unused exception slots and payload
    words past ``M*w/32`` are 0.
    """
    n, m = x.shape
    if m != MINIBLOCK:
        raise ValueError(f"x must be (n_blocks, {MINIBLOCK}), got {tuple(x.shape)}")
    dev = x.device
    u = x.contiguous().view(torch.int32).to(torch.int64) & _M32
    prev = torch.cat([u[:, :1], u[:, :-1]], dim=1)
    d = (u - prev) & _M32
    d = d - ((d >> 31) << 32)                      # signed 32-bit delta
    zig = ((d << 1) ^ (d >> 31)) & _M32
    nbits = significant_bits(zig)
    widths = choose_width(nbits)

    # exceptions: the first MAX_EXC positions over the width, in order
    over = nbits > widths[:, None]
    rank = torch.cumsum(over, dim=1) - 1
    take = over & (rank < MAX_EXC)
    b, t = take.nonzero(as_tuple=True)
    slot = b * MAX_EXC + rank[b, t]
    exc_idx = torch.zeros(n * MAX_EXC, dtype=torch.int64, device=dev)
    exc_val = torch.zeros(n * MAX_EXC, dtype=torch.int64, device=dev)
    exc_idx[slot] = t
    exc_val[slot] = zig[b, t]
    exc_count = over.sum(1).clamp(max=MAX_EXC)

    # LSB-first bit stream at w bits per value; fields are disjoint, so a
    # sum of the shifted pieces is their OR
    j0, s, mask, w = _stream_geometry(widths, m)
    v = zig & mask
    lo = (v << s) & _M32
    hi = torch.where(s + w > 32, v >> (32 - s), 0)
    base = torch.arange(n, dtype=torch.int64, device=dev)[:, None] * m
    packed = torch.zeros(n * m, dtype=torch.int64, device=dev)
    packed.index_add_(0, (base + j0).reshape(-1), lo.reshape(-1))
    packed.index_add_(0, (base + (j0 + 1).clamp(max=m - 1)).reshape(-1), hi.reshape(-1))
    return (_to_i32(packed).reshape(n, m), widths.to(torch.int32),
            _to_i32(u[:, 0]), exc_idx.to(torch.int32).reshape(n, MAX_EXC),
            _to_i32(exc_val).reshape(n, MAX_EXC), exc_count.to(torch.int32))


def decode_blocks_ref(packed, widths, anchors, exc_idx, exc_val, exc_count) -> torch.Tensor:
    """Plain version of :func:`repro_torch.kernels.fp_delta.kernel.decode_blocks`:
    the inverse of :func:`encode_blocks_ref` -> (n_blocks, MINIBLOCK) float32.

    Exceptions follow the reference's ``inject_exceptions``: live slots
    (``slot < exc_count``) whose positions coincide sum their values.
    """
    n, m = packed.shape
    dev = packed.device
    words = packed.to(torch.int64) & _M32
    # a width outside the format unpacks as zeros (the reference selects
    # among the packing widths)
    known = torch.isin(widths, torch.tensor((0,) + WIDTHS, dtype=widths.dtype, device=dev))
    j0, s, mask, _ = _stream_geometry(torch.where(known, widths, 0), m)
    w0 = torch.gather(words, 1, j0)
    w1 = torch.gather(words, 1, (j0 + 1).clamp(max=m - 1))
    # s == 0: w1 << 32 has no bits under the mask
    zig = ((w0 >> s) | (w1 << (32 - s))) & mask & _M32

    idx = exc_idx.to(torch.int64)
    live = ((torch.arange(MAX_EXC, device=dev)[None, :] < exc_count.to(torch.int64)[:, None])
            & (idx >= 0) & (idx < m))
    b = torch.arange(n, dtype=torch.int64, device=dev)[:, None].expand(n, MAX_EXC)
    pos = (b * m + idx)[live]
    patch = torch.zeros(n * m, dtype=torch.int64, device=dev)
    patch.index_add_(0, pos, exc_val.to(torch.int64)[live] & _M32)
    hit = torch.zeros(n * m, dtype=torch.bool, device=dev)
    hit[pos] = True
    zig = torch.where(hit.reshape(n, m), patch.reshape(n, m) & _M32, zig)

    delta = ((zig >> 1) ^ (-(zig & 1) & _M32)) & _M32
    xi = (anchors.to(torch.int64)[:, None] + torch.cumsum(delta, dim=1)) & _M32
    return _to_i32(xi).view(torch.float32)


def payload_words(widths: torch.Tensor) -> torch.Tensor:
    """Valid packed word count per block (for stream compaction)."""
    return (widths.to(torch.int64) * MINIBLOCK) // 32


def stream_size_bits(widths: torch.Tensor, exc_count: torch.Tensor) -> int:
    """Total compacted stream: payloads + exceptions + anchors/widths/counts."""
    per_block_fixed = 32 + 8 + 8  # anchor + width byte + exception count byte
    return (int(payload_words(widths).sum()) * 32
            + int(exc_count.to(torch.int64).sum()) * EXC_BITS
            + int(widths.shape[0]) * per_block_fixed)


# ---------------------------------------------------------------- page stream


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
