"""Seconds from the process start to the window: imports, CUDA start-up,
the kernels' build or load, data generation, the write and the warm-up
query; the reference's work and the drawing of the queries, timed apart,
are left out (host clock)."""


def read(run):
    return run.setup_s
