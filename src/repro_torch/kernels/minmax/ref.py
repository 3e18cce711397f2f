"""Plain PyTorch versions of the min/max kernels, and the host key math.

Two reductions live here, each the plain version of a CUDA kernel in
:mod:`.kernel`:

* :func:`page_minmax_ref` — per-page ``[min, max]`` of a float32 column over
  ragged page bounds (the write path's zone statistics).
* :func:`segminmax_refine_ref` — per-record ``[min, max]`` of the decoded
  x and y bit patterns in order-key space, and the NaN-fenced bbox survivor
  test of the fused read path.

:func:`keep_from_minmax_ref` is no kernel's plain version: it compares the
per-record keys :func:`segminmax_refine_ref` (or its kernel) writes with a
stack of query boxes, as the query server needs, in torch elementwise work
on the keys' own device.

Order keys
----------

``key(v)`` is the total-order transform of an IEEE float's bit pattern:
flip all bits when the sign bit is set, else set the sign bit. Unsigned key
order is the float total order, with ``-0.0 < +0.0`` and every NaN strictly
above ``key(+inf)`` (positive NaNs) or below ``key(-inf)`` (negative NaNs).
The port holds keys as 64-bit numbers: a float64 pattern's key, or a
float32 pattern's key in the upper 32 bits — so the reference's ``(lo, hi)``
uint32 limb pair is the two halves of one key. Torch has no unsigned 64-bit
compare, so the plain versions compare *signed* keys (``key ^ 2**63``),
which order the same way.

The host query-key math at the bottom is numpy, shared by every device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1


# ------------------------------------------------------------ order-key math
def float_order_keys(bits: torch.Tensor, width: int) -> torch.Tensor:
    """Signed 64-bit order keys (``key ^ 2**63``) of decoded bit patterns.

    ``bits`` is int32 (``width == 32``) or int64 (``width == 64``). Signed
    keys compare like the unsigned keys of the module docstring.
    """
    if width == 32:
        b = bits.to(torch.int32)
        s = b ^ ((b >> 31) & 0x7FFFFFFF)
        return s.to(torch.int64) << 32
    b = bits.to(torch.int64)
    return b ^ ((b >> 63) & _I64_MAX)


def unsigned_key_bits(skey: torch.Tensor) -> torch.Tensor:
    """Signed order keys -> the unsigned key's bit pattern, as int64."""
    return skey ^ _I64_MIN


def _ragged_index(starts: torch.Tensor, counts: torch.Tensor):
    """(owner, position) of every element of the slices ``[s, s + c)``."""
    n = starts.shape[0]
    owner = torch.repeat_interleave(
        torch.arange(n, device=starts.device), counts)
    excl = torch.cumsum(counts, 0) - counts
    pos = (torch.arange(owner.shape[0], device=starts.device)
           - excl[owner] + starts[owner])
    return owner, pos


def segminmax_refine_ref(bits, x_start, y_start, counts, valid, qkeys, width):
    """Plain version of :func:`repro_torch.kernels.minmax.kernel.segminmax_refine`.

    ``bits``: decoded stream patterns; ``x_start``/``y_start``/``counts``:
    (R,) int64 record slices; ``valid``: (R,) bool; ``qkeys``: the four
    64-bit unsigned query keys ``(qx0, qx1, qy0, qy1)`` as Python ints.
    Returns ``(keep (R,) bool, mm (R, 4) int64)`` where ``mm`` holds the
    unsigned key bit patterns of (x_min, x_max, y_min, y_max); a record
    with no values gets the identities (all ones, zero).
    """
    n = counts.shape[0]
    keys = float_order_keys(bits, width)
    owner, xpos = _ragged_index(x_start, counts)
    _, ypos = _ragged_index(y_start, counts)
    dev = bits.device

    def reduce(pos, how, ident):
        out = torch.full((n,), ident, dtype=torch.int64, device=dev)
        return out.scatter_reduce_(0, owner, keys[pos], how, include_self=True)

    xmn = reduce(xpos, "amin", _I64_MAX)
    xmx = reduce(xpos, "amax", _I64_MIN)
    ymn = reduce(ypos, "amin", _I64_MAX)
    ymx = reduce(ypos, "amax", _I64_MIN)
    qx0, qx1, qy0, qy1 = (_signed(q) for q in qkeys)
    (neg, pos) = (_signed(k) for k in inf_keys64(width))
    keep = (valid
            & (xmn <= qx1) & (xmx >= qx0) & (ymn <= qy1) & (ymx >= qy0)
            & (xmx <= pos) & (xmn >= neg) & (ymx <= pos) & (ymn >= neg))
    mm = unsigned_key_bits(torch.stack([xmn, xmx, ymn, ymx], 1))
    return keep, mm


def _signed(ukey: int) -> int:
    """Unsigned 64-bit key -> its signed compare form."""
    return ukey - (1 << 63)


def keep_from_minmax_ref(mm, valid, qkeys, qvalid, width: int) -> torch.Tensor:
    """(R, 4) per-record min/max keys × Q query boxes → (Q, R) survivor mask.

    ``mm`` is :func:`segminmax_refine_ref`'s second output (unsigned key bit
    patterns of x_min, x_max, y_min, y_max as int64); ``valid``: (R,) bool
    on ``mm``'s device; ``qkeys``: (Q, 4, 2) uint32 limbs from
    :func:`stack_bbox_query_keys`, ``qvalid`` its (Q,) bool. Row q is the
    survivor test of :func:`segminmax_refine_ref` with query q's keys,
    verbatim (signed keys, so negative coordinates order right; the NaN
    fence; ``valid`` drops records with no values, which hold the
    identities); a row with ``qvalid[q]`` False keeps nothing.
    """
    dev = mm.device
    q = torch.tensor([[_signed(k) for k in keys64(row)] for row in qkeys],
                     dtype=torch.int64, device=dev).reshape(-1, 4, 1)
    smm = mm ^ _I64_MIN
    xmn, xmx, ymn, ymx = (smm[:, i][None] for i in range(4))
    neg, pos = (_signed(k) for k in inf_keys64(width))
    qv = torch.as_tensor(np.asarray(qvalid, bool), device=dev)[:, None]
    return (qv & valid[None]
            & (xmn <= q[:, 1]) & (xmx >= q[:, 0])
            & (ymn <= q[:, 3]) & (ymx >= q[:, 2])
            & (xmx <= pos) & (xmn >= neg) & (ymx <= pos) & (ymn >= neg))


def page_minmax_ref(values: torch.Tensor, bounds: torch.Tensor):
    """Plain version of :func:`repro_torch.kernels.minmax.kernel.page_minmax`.

    ``values``: float32 column; ``bounds``: (P + 1,) int64 page offsets.
    Min/max follow the IEEE total order (``-0.0 < +0.0``) with each
    denormal counted as the zero of its sign (the reference's XLA reduction
    flushes denormal inputs); empty pages give ``(+inf, -inf)``; a page
    holding NaN gives its largest NaN bit pattern for both.
    """
    n_pages = bounds.shape[0] - 1
    dev = values.device
    counts = bounds[1:] - bounds[:-1]
    page = torch.repeat_interleave(torch.arange(n_pages, device=dev), counts)
    v = values[bounds[0]:bounds[-1]] if n_pages else values[:0]
    b = v.view(torch.int32)
    b = torch.where((b & 0x7F800000) == 0, b & -0x80000000, b)  # denormal -> ±0
    k = b ^ ((b >> 31) & 0x7FFFFFFF)  # int32 order key; its own inverse
    nan = torch.isnan(v)
    kpos, kneg = 0x7F800000, -0x7F800001  # keys of +inf (0x7F800000), -inf (0xFF800000)
    kmn = torch.full((n_pages,), kpos, dtype=torch.int32, device=dev)
    kmx = torch.full((n_pages,), kneg, dtype=torch.int32, device=dev)
    kmn.scatter_reduce_(0, page, torch.where(nan, kpos, k), "amin")
    kmx.scatter_reduce_(0, page, torch.where(nan, kneg, k), "amax")
    # NaN patterns as unsigned 32-bit values in int64 (0 = no NaN)
    nanbits = torch.zeros(n_pages, dtype=torch.int64, device=dev)
    nanbits.scatter_reduce_(
        0, page, torch.where(nan, b.to(torch.int64) & 0xFFFFFFFF, 0), "amax")
    bmn = (kmn ^ ((kmn >> 31) & 0x7FFFFFFF)).to(torch.int64) & 0xFFFFFFFF
    bmx = (kmx ^ ((kmx >> 31) & 0x7FFFFFFF)).to(torch.int64) & 0xFFFFFFFF
    bmn = torch.where(nanbits != 0, nanbits, bmn)
    bmx = torch.where(nanbits != 0, nanbits, bmx)
    return _f32_from_u32(bmn), _f32_from_u32(bmx)


def _f32_from_u32(u: torch.Tensor) -> torch.Tensor:
    """uint32 patterns held in int64 -> float32 values with those bits."""
    return (u - ((u >> 31) << 32)).to(torch.int32).view(torch.float32)


# -------------------------------------------------- host-side query-key math
def float_order_key_np(v, dtype: np.dtype) -> tuple[int, int]:
    """Host mirror of the order-key transform for one scalar: (lo, hi)."""
    dtype = np.dtype(dtype)
    if dtype.itemsize == 4:
        u = int(np.array(v, dtype).view(np.uint32))
        k = u ^ (0xFFFFFFFF if u >> 31 else 0x80000000)
        return 0, k
    u = int(np.array(v, dtype).view(np.uint64))
    lo, hi = u & 0xFFFFFFFF, u >> 32
    if hi >> 31:
        return lo ^ 0xFFFFFFFF, hi ^ 0xFFFFFFFF
    return lo, hi ^ 0x80000000


def _canonical_bound(q: float, dtype: np.dtype, side: str):
    """Tightest ``dtype`` value usable for an exact float64-query compare.

    ``side == "hi"`` (tests ``v <= q``): the largest dtype value ``<= q``;
    ``side == "lo"`` (tests ``v >= q``): the smallest dtype value ``>= q``.
    Zeros canonicalize to the extreme key of the {-0.0, +0.0} equivalence
    class so key-space compares match float compares. Returns None for NaN.
    """
    q = float(q)
    if math.isnan(q):
        return None
    if np.dtype(dtype).itemsize == 4:
        with np.errstate(over="ignore"):  # out-of-range bounds round to ±inf
            qf = np.float32(q)
        # compare in float64 explicitly: NEP 50 would weakly demote the
        # Python float to float32 and the tightening would never fire
        if side == "hi" and float(qf) > q:
            qf = np.nextafter(qf, np.float32(-np.inf))
        elif side == "lo" and float(qf) < q:
            qf = np.nextafter(qf, np.float32(np.inf))
        q = float(qf)
        one = np.float32
    else:
        one = np.float64
    if q == 0.0:
        q = 0.0 if side == "hi" else -0.0
    return one(q)


def bbox_query_keys(bbox, dtype: np.dtype) -> np.ndarray | None:
    """Query bbox -> (4, 2) uint32 key limbs ``[(lo, hi) for x0, x1, y0, y1]``.

    Bounds are canonicalized per coordinate dtype (float32 bounds round to
    the tightest representable value, zeros pick the matching signed zero)
    so the device key compare is *exactly* the host float compare. Returns
    None when the bbox is empty under the shared canonicalization rule
    (:func:`repro_torch.core.filters.canonical_bbox`: NaN bound or inverted
    extent) — the host test then keeps no record, matching the shard- and
    page-level pruning answer for the same bbox.
    """
    from repro_torch.core.filters import canonical_bbox

    bbox = canonical_bbox(bbox)
    if bbox is None:
        return None
    qx0, qy0, qx1, qy1 = bbox
    vals = (
        _canonical_bound(qx0, dtype, "lo"),
        _canonical_bound(qx1, dtype, "hi"),
        _canonical_bound(qy0, dtype, "lo"),
        _canonical_bound(qy1, dtype, "hi"),
    )
    if any(v is None for v in vals):
        return None
    keys = [float_order_key_np(v, dtype) for v in (vals[0], vals[1], vals[2], vals[3])]
    return np.array(keys, dtype=np.uint32)


def stack_bbox_query_keys(bboxes, dtype: np.dtype) -> tuple[np.ndarray, np.ndarray]:
    """Stack per-query bbox key limbs for a multi-query refine launch.

    Returns ``(keys, valid)``: ``keys`` is ``(Q, 4, 2)`` uint32 (row q is
    :func:`bbox_query_keys` of ``bboxes[q]``), ``valid`` is ``(Q,)`` bool.
    A NaN-bound bbox gets a zero key row and ``valid[q] = False`` — the host
    keeps no record for it, so the multi-query refine masks that row out
    after the launch instead of fencing it in key space.
    """
    keys = np.zeros((len(bboxes), 4, 2), np.uint32)
    valid = np.zeros(len(bboxes), bool)
    for q, bbox in enumerate(bboxes):
        k = bbox_query_keys(bbox, dtype)
        if k is not None:
            keys[q] = k
            valid[q] = True
    return keys, valid


def inf_keys(width: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """Order keys of (-inf, +inf) as ((lo, hi), (lo, hi)) for NaN fencing."""
    dtype = np.float32 if width == 32 else np.float64
    return (float_order_key_np(-np.inf, dtype), float_order_key_np(np.inf, dtype))


def keys64(limbs) -> tuple[int, ...]:
    """``(lo, hi)`` uint32 limb pairs -> 64-bit unsigned keys ``hi << 32 | lo``."""
    return tuple((int(hi) << 32) | int(lo) for lo, hi in np.asarray(limbs).reshape(-1, 2))


def inf_keys64(width: int) -> tuple[int, int]:
    """64-bit unsigned keys of (-inf, +inf)."""
    return keys64(inf_keys(width))
