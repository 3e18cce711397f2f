"""Millions of points over the wall time of the one ``write_file`` call in
set-up, which ends when the file is closed (host clock)."""


def read(run):
    if not run.write_s:
        return None
    return run.n_points / run.write_s / 1e6
