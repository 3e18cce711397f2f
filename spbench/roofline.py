"""Peaks of the card and the bytes each read-path kernel needs.

Peaks: NVIDIA H100 SXM5 80 GB data sheet, 700 W: 3.35 TB/s of HBM. A
kernel's least time is the bytes its work needs over that rate; its share
of the roofline is that least time over the profiler's time of the kernel.

Bytes are counted from what the queries need, never from launch geometry,
padding or the program's host-built side arrays, so any implementation is
held to the same work:

* the page-stream decode (kernel 1) reads the compressed coordinate pages
  the index kept and writes ``width / 8`` bytes a decoded value;
* the refine (kernel 2) reads those decoded values and writes one byte a
  record (its keep mask).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12

DECODE_KERNEL = "decode_stream_kernel"   # csrc/fp_delta_decode.cu
REFINE_KERNEL = "segminmax_refine"       # csrc/segminmax_refine.cu


def decode_bytes(page_bytes: int, values: int, width: int) -> int:
    return int(page_bytes) + int(values) * width // 8


def refine_bytes(values: int, records: int, width: int) -> int:
    return int(values) * width // 8 + int(records)


def share_pct(nbytes: int, kernel_s: float) -> float | None:
    """Per cent of the roofline; ``None`` when the kernel never ran."""
    if kernel_s <= 0 or nbytes <= 0:
        return None
    return 100.0 * (nbytes / HBM_BYTES_PER_S) / kernel_s
