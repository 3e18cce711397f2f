"""Layer: kernels. Kernel 2 (``csrc/segminmax_refine.cu``): the least time of
the bytes the window's queries need (``width / 8`` bytes a decoded value in,
one byte a record out) at the HBM rate, over the profiler's time of the
kernel, in per cent. Values, records and width come from the
``device.refine_launch`` spans."""

from spbench import roofline


def read(run):
    if run.device is None or not run.spans:
        return None
    launches = [s for s in run.spans if s["name"] == "device.refine_launch"]
    if not launches:
        return None
    nbytes = sum(roofline.refine_bytes(s["args"]["values"], s["args"]["records"],
                                       s["args"]["width"]) for s in launches)
    return roofline.share_pct(nbytes, run.device.kernel_s(roofline.REFINE_KERNEL))
