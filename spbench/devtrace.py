"""The device timeline of a traced window, from ``torch.profiler``'s trace.

:class:`DeviceTrace` holds every kernel, copy and memset the card ran inside
the window (microseconds on the profiler's clock), the window itself (the
``spbench.window`` annotation the harness opens around its loop) and the
offset that maps the program's obs spans onto that clock. From them come
the busy time (the union of the device intervals), the device operations
that took most time, and the idle gaps named by the innermost obs span the
host had open.
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from dataclasses import dataclass

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_MARK = "spbench.window"


@dataclass
class DeviceTrace:
    window: tuple[float, float]          # us, profiler clock
    ops: list[tuple[float, float, str]]  # (start us, end us, name), clipped to the window
    span_offset_us: float = 0.0          # profiler ts = obs ts + this

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def intervals(self) -> list[tuple[float, float]]:
        """The union of the device intervals, sorted."""
        out: list[list[float]] = []
        for a, b, _ in sorted(self.ops):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals()) / 1e6

    def kernel_s(self, pattern: str) -> float:
        """Seconds of the kernels whose name contains ``pattern``."""
        return sum(b - a for a, b, n in self.ops if pattern in n) / 1e6

    def top_ops(self, k: int = 10) -> list[list]:
        agg: dict[str, float] = defaultdict(float)
        for a, b, n in self.ops:
            agg[short_name(n)] += (b - a) / 1e6
        return [[n, s] for n, s in sorted(agg.items(), key=lambda t: -t[1])[:k]]

    def gaps(self) -> list[tuple[float, float]]:
        w0, w1 = self.window
        out, t = [], w0
        for a, b in self.intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if w1 > t:
            out.append((t, w1))
        return out

    def idle_by_span(self, spans: list[dict], thread: int | None, k: int = 10) -> list[list]:
        """Idle seconds by the innermost obs span open on ``thread``
        (``"outside any span"`` where none was), largest first."""
        segs = innermost_segments([s for s in spans if thread is None or s["tid"] == thread],
                                  self.span_offset_us)
        starts = [s[0] for s in segs]
        agg: dict[str, float] = defaultdict(float)
        for g0, g1 in self.gaps():
            covered = 0.0
            i = max(0, bisect.bisect_right(starts, g0) - 1)
            while i < len(segs) and segs[i][0] < g1:
                a, b, name = segs[i]
                if min(b, g1) > max(a, g0):
                    agg[name] += (min(b, g1) - max(a, g0)) / 1e6
                    covered += min(b, g1) - max(a, g0)
                i += 1
            if g1 - g0 > covered:
                agg["outside any span"] += (g1 - g0 - covered) / 1e6
        return [[n, s] for n, s in sorted(agg.items(), key=lambda t: -t[1])[:k]]


def short_name(name: str) -> str:
    """A device operation's name without its namespace noise, argument list
    or return type, at most 120 characters."""
    name = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    return re.sub(r"\(.*$", "", name).strip()[:120]


def innermost_segments(spans: list[dict], offset_us: float) -> list[tuple[float, float, str]]:
    """Non-overlapping (start, end, name) pieces of one thread's nested spans,
    each named by the innermost span open there (profiler clock)."""
    ev = sorted(((s["ts"] + offset_us, s["ts"] + offset_us + s["dur"], s["name"]) for s in spans),
                key=lambda e: (e[0], -e[1]))
    out: list[tuple[float, float, str]] = []
    stack: list[tuple[float, float, str]] = []
    t = None

    def emit(upto):
        nonlocal t
        if stack and t is not None and upto > t:
            out.append((t, upto, stack[-1][2]))
        t = upto

    for e in ev:
        while stack and stack[-1][1] <= e[0]:
            emit(stack[-1][1])
            stack.pop()
        emit(e[0])
        stack.append(e)
    while stack:
        emit(stack[-1][1])
        stack.pop()
    return out


def parse(path, mark_obs_us: float | None = None) -> DeviceTrace:
    """Read a chrome trace written by ``torch.profiler``.

    ``mark_obs_us`` is the obs tracer's clock (us) when the window
    annotation opened; it fixes the offset from obs spans to this clock.
    """
    with open(path) as fh:
        doc = json.load(fh)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    marks = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW_MARK
             and e.get("cat") in ("user_annotation", "cpu_op")]
    if not marks:
        raise ValueError("the trace holds no window annotation")
    m = marks[0]
    w0, w1 = float(m["ts"]), float(m["ts"]) + float(m["dur"])
    ops = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        a, b = max(a, w0), min(b, w1)
        if b > a:
            ops.append((a, b, str(e.get("name", ""))))
    off = w0 - mark_obs_us if mark_obs_us is not None else 0.0
    return DeviceTrace((w0, w1), ops, off)
