"""File bytes over points stored: the paper's storage claim (the file's
size on disk, read in set-up)."""


def read(run):
    if not run.file_bytes or not run.n_points:
        return None
    return run.file_bytes / run.n_points
