"""Layer: host plan. Process CPU seconds, timed by the harness around each
call, over GB (1e9 bytes) of stored blobs read (``ReadStats.bytes_read``),
summed over the window's queries."""


def read(run):
    ok = [q for q in run.queries if q.error is None]
    gb = sum(q.bytes_read for q in ok) / 1e9
    if gb <= 0:
        return None
    return sum(q.cpu_s for q in ok) / gb
