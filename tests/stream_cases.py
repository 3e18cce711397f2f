"""Stored pages for the page stream's compact form and its expansion.

Each case is a list of stored pages of one column (payload bytes, value
count, encoding), made with the port's encoder from a seed. Both packages'
planners read the same bytes, so the tests can hold the port's compact
stream, its host expansion and its card expansion against the JAX
package's arrays. Imports only the port: the card-only tests use it where
JAX is not installed.
"""

import numpy as np

from repro_torch.core.fp_delta import delta_bit_histogram, fp_delta_encode, fp_delta_plan
from repro_torch.core.pages import PageMeta, page_stream_plan

STREAM_BLOCK = 1024

# name -> page sizes; "r" marks a raw page. Escapes: none, <= 4 a page (the
# fixpoint resolver), many (the candidate scan); raw and single-value pages,
# empty pages between others, a value count that fills whole blocks, no
# values at all, and the token widths 1 and W - 1 and 8 over wild bits (far
# more runs of n ones than tokens).
CASES = {
    "no_escapes": [900, 2500],
    "few_escapes": [3000, 1200],
    "many_escapes": [3000, 1700],
    "raw": [800, "r700", 1, "r1", 300],
    "single_values": [1, 1, 700, 1],
    "empty_middle": [900, 0, 1200, 0, 0, 40],
    "exact_blocks": [1500, 548],
    "all_empty": [0, 0],
    "extreme_widths": [2000, 2000, 1500],
}


def _no_escape_bits(x):
    """A token width at which no delta of ``x`` escapes: one bit more than
    the widest zigzag, so none equals the all-ones marker either."""
    h = delta_bit_histogram(x)
    return int(np.flatnonzero(h)[-1]) + 1 if h.any() else 1


def _page(rng, case, i, n, dtype):
    """A page's values and the token width to encode it at (None: n*)."""
    x = (np.cumsum(rng.normal(0, 1e-4, n)) + 40.7).astype(dtype)
    if n < 2 or case in ("raw", "single_values"):
        return x, None
    if case == "extreme_widths":
        if i == 0:  # n = 1: the marker is a single one, every change escapes
            return np.repeat(x[::5], 5)[:n], 1
        uint = np.uint32 if np.dtype(dtype).itemsize == 4 else np.uint64
        wild = rng.integers(0, np.iinfo(uint).max, n, dtype=uint, endpoint=True).view(dtype)
        return wild, (8 * np.dtype(dtype).itemsize - 1 if i == 1 else 8)
    n_bits = _no_escape_bits(x)
    if case == "few_escapes":
        # a spike escapes twice (out and back), a jump at the end once
        if i == 0:
            x[n // 3] = 1e30
        x[-1] = -1e30
    elif case == "many_escapes":
        if i == 0:
            x[rng.integers(1, n, n // 50)] = rng.normal(0, 1e30, n // 50).astype(dtype)
        else:  # wild bit patterns: nearly every delta escapes
            uint = np.uint32 if np.dtype(dtype).itemsize == 4 else np.uint64
            x = rng.integers(0, np.iinfo(uint).max, n, dtype=uint, endpoint=True).view(dtype)
            n_bits = 8
    elif case != "no_escapes":
        x[rng.integers(1, n, 8)] = 1e20
        n_bits = None
    return x, n_bits


def stored_pages(rng, case, dtype):
    """``[(payload, n_values, encoding)]`` of every page of ``case``."""
    out = []
    for i, size in enumerate(CASES[case]):
        raw = isinstance(size, str)
        n = int(size[1:]) if raw else size
        x, n_bits = _page(rng, case, i, n, dtype)
        if raw:
            out.append((x.tobytes(), n, "raw"))
        else:
            out.append((fp_delta_encode(x, n_bits)[0] if n else b"", n, "fp_delta"))
    return out


def random_pages(rng, dtype, n_values, page_values=131_072):
    """Stored pages of about ``n_values`` values in pages of random sizes,
    each with its own escape density, raw pages among them."""
    out = []
    total = 0
    while total < n_values:
        n = int(rng.integers(1, page_values))
        x = (np.cumsum(rng.normal(0, 1e-5, n)) + 40.7).astype(dtype)
        k = int(rng.integers(0, max(n // 20, 1)))
        x[rng.integers(0, n, k)] = rng.normal(0, 1e3, k).astype(dtype)
        if rng.random() < 0.1:
            out.append((x.tobytes(), n, "raw"))
        else:
            out.append((fp_delta_encode(x)[0], n, "fp_delta"))
        total += n
    return out


def raw_meta(nbytes, n):
    return dict(offset=0, nbytes=nbytes, count=n, rec_start=0, rec_count=0, vmin=0.0,
                vmax=0.0, encoding="raw", n_bits=0, n_resets=0)


def port_plans(pages, dtype):
    """The port's plans of stored pages (raw pages as synthetic raw plans)."""
    dtype = np.dtype(dtype)
    return [page_stream_plan(b, PageMeta(**raw_meta(len(b), n)), dtype, "none")
            if enc == "raw" else fp_delta_plan(b, n, dtype) for b, n, enc in pages]
