"""Wrappers of the min/max CUDA kernels (``csrc/page_minmax.cu``,
``csrc/segminmax_refine.cu``).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream, raises on a
CUDA error, and counts its launches in a plain integer attribute
(``page_minmax.launches``, bumped under a lock by ``_build.bump``) so a run
can show that it went through the kernel. The plain versions are in :mod:`.ref`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_P = ctypes.c_void_p


def _cuda_contig(t: torch.Tensor, name: str, dtype: torch.dtype, dev: torch.device):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def page_minmax(values: torch.Tensor, bounds: torch.Tensor):
    """Per-page (min, max) float32 of ``values`` over ragged ``bounds``.

    ``values``: (n,) float32 CUDA tensor; ``bounds``: (P + 1,) int64 page
    offsets on the same device, ``0 <= bounds[0] <= ... <= bounds[P] <= n``.
    One launch; the two results are the rows of one (2, P) allocation.
    See :func:`.ref.page_minmax_ref`.
    """
    dev = values.device
    if dev.type != "cuda":
        raise ValueError("page_minmax kernel needs CUDA tensors")
    _cuda_contig(values, "values", torch.float32, dev)
    _cuda_contig(bounds, "bounds", torch.int64, dev)
    if values.dim() != 1 or bounds.dim() != 1 or bounds.shape[0] < 1:
        raise ValueError("values must be 1-D and bounds 1-D with >= 1 entry")
    n_pages = bounds.shape[0] - 1
    out = torch.empty((2, n_pages), dtype=torch.float32, device=dev)
    fn = _build.entry("page_minmax", "pmm_page_minmax", [_P, _P, ctypes.c_int, _P, _P, _P])
    err = fn(values.data_ptr(), bounds.data_ptr(), n_pages,
             out.data_ptr(), out.data_ptr() + 4 * n_pages, _stream(dev))
    _build.check(_build.load("page_minmax"), "pmm", err, "page_minmax launch")
    _build.bump(page_minmax)
    mn, mx = out.unbind(0)
    return mn, mx


page_minmax.launches = 0


def segminmax_refine(bits, x_start, y_start, counts, valid, qkeys, width: int):
    """Per-record order-key min/max and the NaN-fenced bbox survivor test.

    ``bits``: decoded patterns, int32 (``width == 32``) or int64 (64);
    ``x_start``/``y_start``/``counts``: (R,) int64; ``valid``: (R,) bool;
    ``qkeys``: four unsigned 64-bit query keys (Python ints). Returns
    ``(keep (R,) bool, mm (R, 4) int64)``; see :func:`.ref.segminmax_refine_ref`.
    """
    dev = bits.device
    if dev.type != "cuda":
        raise ValueError("segminmax_refine kernel needs CUDA tensors")
    if width not in (32, 64):
        raise ValueError(f"width must be 32 or 64, got {width}")
    _cuda_contig(bits, "bits", torch.int32 if width == 32 else torch.int64, dev)
    n = counts.shape[0]
    for t, name in ((x_start, "x_start"), (y_start, "y_start"), (counts, "counts")):
        _cuda_contig(t, name, torch.int64, dev)
        if t.shape != (n,):
            raise ValueError(f"{name} must have shape ({n},), got {tuple(t.shape)}")
    _cuda_contig(valid, "valid", torch.bool, dev)
    if valid.shape != (n,):
        raise ValueError(f"valid must have shape ({n},), got {tuple(valid.shape)}")
    keep = torch.empty(n, dtype=torch.bool, device=dev)
    mm = torch.empty((n, 4), dtype=torch.int64, device=dev)
    u64 = ctypes.c_uint64
    fn = _build.entry("segminmax_refine", "smm_refine",
                      [_P, ctypes.c_int, _P, _P, _P, _P, ctypes.c_longlong,
                       u64, u64, u64, u64, _P, _P, _P])
    qx0, qx1, qy0, qy1 = (int(q) for q in qkeys)
    err = fn(bits.data_ptr(), width, x_start.data_ptr(), y_start.data_ptr(),
             counts.data_ptr(), valid.data_ptr(), n, qx0, qx1, qy0, qy1,
             keep.data_ptr(), mm.data_ptr(), _stream(dev))
    _build.check(_build.load("segminmax_refine"), "smm", err, "segminmax_refine launch")
    _build.bump(segminmax_refine)
    return keep, mm


segminmax_refine.launches = 0
