"""Bytes of the result arrays returned to the caller (float64 x and y of
every surviving point, plus the extra columns), in MB (1e6 bytes), over the
whole window, the last query's overrun included (host clock)."""


def read(run):
    if not run.queries or run.window_s <= 0:
        return None
    return sum(q.result_bytes for q in run.queries) / run.window_s / 1e6
