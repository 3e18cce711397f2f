"""Dispatch for the min/max kernels, and the writer's zone-stats entry.

Dispatch follows the tensor's device: a CUDA tensor launches the kernel of
:mod:`.kernel` (or raises), a CPU tensor runs the plain version of
:mod:`.ref`. There is no flag and no fallback between them.

``column_page_stats`` takes the ragged record-aligned pages directly (one
offset per page) in one ``page_minmax`` launch: the TPU version's edge
padding to its 2048-value tile, and the budgeted batching that bounded the
padded matrix, have no counterpart here. ``segminmax_refine`` is the
record-level reduction of :func:`repro_torch.kernels.fp_delta.decode_refine_stream`;
``keep_from_minmax`` compares the per-record keys it writes with a stack of
query boxes, as the query server needs, in torch elementwise work on the
keys' own device (one implementation for every device).
"""

from __future__ import annotations

import numpy as np
import torch

from ..._device import torch_device
from . import kernel, ref
from .ref import _I64_MIN, _signed, inf_keys64, keys64


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def page_minmax(values: torch.Tensor, bounds: torch.Tensor):
    """Per-page (min, max) of a float32 column over ragged ``bounds``."""
    if _on_cuda(values):
        return kernel.page_minmax(values, bounds)
    return ref.page_minmax_ref(values, bounds)


def segminmax_refine(bits, x_start, y_start, counts, valid, qkeys, width: int):
    """Per-record key min/max + bbox survivor mask; see :func:`.ref.segminmax_refine_ref`."""
    if _on_cuda(bits):
        return kernel.segminmax_refine(bits, x_start, y_start, counts, valid,
                                       qkeys, width)
    return ref.segminmax_refine_ref(bits, x_start, y_start, counts, valid,
                                    qkeys, width)


def keep_from_minmax(mm, valid, qkeys, qvalid, width: int) -> torch.Tensor:
    """(R, 4) per-record min/max keys × Q query boxes → (Q, R) survivor mask.

    ``mm`` is :func:`segminmax_refine`'s second output (unsigned key bit
    patterns of x_min, x_max, y_min, y_max as int64); ``valid``: (R,) bool
    on ``mm``'s device; ``qkeys``: (Q, 4, 2) uint32 limbs from
    :func:`~.ref.stack_bbox_query_keys`, ``qvalid`` its (Q,) bool. Row q is
    the survivor test of :func:`segminmax_refine` with query q's keys,
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


def column_page_stats(values: np.ndarray, page_bounds: np.ndarray, *,
                      device="cuda"):
    """Ragged host entry: per-page stats for record-aligned page bounds.

    The column goes to ``device`` once and one :func:`page_minmax` launch
    reduces every page; empty pages come back as ``(+inf, -inf)``.
    Returns float64 arrays holding the float32 results.
    """
    values = np.asarray(values, dtype=np.float32)
    bounds = np.asarray(page_bounds, dtype=np.int64)
    counts = np.diff(bounds)
    n_pages = len(counts)
    if n_pages == 0:
        return np.zeros(0), np.zeros(0)
    out_min = np.full(n_pages, np.inf)
    out_max = np.full(n_pages, -np.inf)
    if len(values) == 0 or (counts == 0).all():
        return out_min, out_max
    dev = torch_device(device)
    v = torch.from_numpy(np.ascontiguousarray(values)).to(dev)
    b = torch.from_numpy(np.ascontiguousarray(bounds)).to(dev)
    mn, mx = page_minmax(v, b)
    out_min[:] = mn.cpu().numpy()
    out_max[:] = mx.cpu().numpy()
    return out_min, out_max


def column_page_stats_ex(values: np.ndarray, page_bounds: np.ndarray, *,
                         device="cuda"):
    """NaN-aware per-page stats for any numeric dtype: (vmin, vmax, nnan).

    ``vmin``/``vmax`` are the per-page extrema over *non-NaN* values in the
    column's own dtype (``(+inf, -inf)`` for pages with none — empty or
    all-NaN), ``nnan`` the per-page NaN count. float32 columns reduce
    through the batched :func:`page_minmax` launch (the cast in
    :func:`column_page_stats` is exact for them); wider/integer dtypes use
    an exact host segmented reduction, since a float32 round-trip could
    move a bound across a value and make pruning unsound.
    """
    values = np.asarray(values)
    bounds = np.asarray(page_bounds, dtype=np.int64)
    counts = np.diff(bounds)
    n_pages = len(counts)
    if n_pages == 0:
        return np.zeros(0), np.zeros(0), np.zeros(0, np.int64)
    if values.dtype.kind == "f" and np.isnan(values).any():
        csum = np.concatenate([[0], np.cumsum(np.isnan(values), dtype=np.int64)])
        nnan = csum[bounds[1:]] - csum[bounds[:-1]]
    else:
        nnan = np.zeros(n_pages, np.int64)
    out_min = np.full(n_pages, np.inf)
    out_max = np.full(n_pages, -np.inf)
    if values.dtype == np.float32:
        out_min, out_max = column_page_stats(values, bounds, device=device)
        # the kernel returns NaN for NaN-carrying pages; recompute them exactly
        for i in np.flatnonzero((nnan > 0) & (nnan < counts)):
            v = values[bounds[i]:bounds[i + 1]]
            out_min[i], out_max[i] = np.fmin.reduce(v), np.fmax.reduce(v)
        all_nan = nnan == counts
        out_min[all_nan], out_max[all_nan] = np.inf, -np.inf
        return out_min, out_max, nnan
    nonempty = np.flatnonzero(counts > 0)
    if len(nonempty):
        # reduceat over non-empty page starts: skipped empty pages contribute
        # zero elements, so each segment reduces exactly one page; fmin/fmax
        # skip NaNs (all-NaN segments yield NaN, patched below)
        starts = bounds[:-1][nonempty]
        mn = np.fmin.reduceat(values, starts)
        mx = np.fmax.reduceat(values, starts)
        out_min[nonempty] = mn
        out_max[nonempty] = mx
        all_nan = nnan == counts
        out_min[all_nan], out_max[all_nan] = np.inf, -np.inf
    return out_min, out_max, nnan
