"""Layer: kernels. Kernel 1 (``csrc/fp_delta_decode.cu``): the least time of
the bytes the window's queries need (the compressed coordinate pages the
index kept, then ``width / 8`` bytes a decoded value) at the HBM rate, over
the profiler's time of the kernel, in per cent. Values and width come from
the ``device.decode_launch`` spans; pages from the reference, their sizes
from the file's footer."""

from spbench import roofline


def read(run):
    if run.device is None or not run.spans or run.page_bytes is None:
        return None
    launches = [s for s in run.spans if s["name"] == "device.decode_launch"]
    if not launches:
        return None
    pages = sum(int(run.page_bytes[q.ref_hit_pages].sum()) for q in run.queries
                if q.ref_hit_pages is not None)
    nbytes = pages + sum(roofline.decode_bytes(0, s["args"]["values"], s["args"]["width"])
                         for s in launches)
    return roofline.share_pct(nbytes, run.device.kernel_s(roofline.DECODE_KERNEL))
