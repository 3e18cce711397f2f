"""Layer: transfer. Time in the ``device.h2d`` and ``device.gather`` spans
(the page streams' upload; the survivors' gather and download) over the
window's wall time, in per cent (program spans, traced run)."""


def read(run):
    if not run.spans or run.window_s <= 0:
        return None
    us = sum(s["dur"] for s in run.spans if s["name"] in ("device.h2d", "device.gather"))
    return 100.0 * us / 1e6 / run.window_s
