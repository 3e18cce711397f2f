"""The page stream's escape resolution: where the escaped values of each
page sit, found on the host (``FPDeltaPlan.flags``, ``escape_resolve_ref``)
or on the card (``kernel.escape_resolve``, ``csrc/stream_expand.cu``).

Pages come from ``tests/stream_cases.py`` (escapes none, few and many; raw,
single-value and empty pages; token widths 1, W - 1 and 8 over wild bits).
On the CPU the host resolution is held against both host resolvers and the
JAX package's plans, and an emulation of the kernel's algorithm (tiles of
word masks, a warp's walk 32 words a step) against the host resolution, at
small tiles so that every tile boundary is crossed. On the card (tests
marked ``cuda``, which skip without one) the kernel is held against the
host resolution, and reads of malformed payloads are refused. This file
imports no JAX at its top, so the card tests run where JAX is not installed:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_escape_resolve.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core.fp_delta import (
    HEADER_BITS,
    _resolve_escapes_fixpoint,
    _resolve_escapes_scan,
    fp_delta_encode,
    fp_delta_plan,
)
from repro_torch.core.reader import SpatialParquetReader
from repro_torch.core.writer import write_file
from repro_torch.data.synthetic import porto_taxi_like
from repro_torch.kernels import fp_delta as tfd
from repro_torch.kernels.fp_delta import kernel as fkernel, ops as fops
from stream_cases import CASES, port_plans, random_pages, raw_meta, stored_pages

_M64 = (1 << 64) - 1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _stream(case, dtype):
    rng = np.random.default_rng(11)
    pages = (random_pages(rng, dtype, 4_000_000) if case == "random_4m"
             else stored_pages(rng, case, dtype))
    return pages, tfd.build_page_stream(port_plans(pages, dtype))


def _every_nth(r, n):
    m, s = 1 << r, n
    while s < 64:
        m |= m << s
        s <<= 1
    return m & _M64


def _kernel_walk(words64, table, n_esc, width, tile=1024, lanes=32):
    """``escape_resolve_kernel``'s algorithm step for step on the host:
    returns ``(escapes, bad)``. A word's mask marks the bits where n ones
    start over the word and the next one of its page; each walk step ANDs
    ``lanes`` consecutive words' masks with the token boundaries from the
    current one, below the end of the tokens, and takes the lowest hit. The
    boundaries' residue is carried across steps and the token index taken by
    a multiply-high, as the kernel does; asserts hold both to the plain
    arithmetic."""
    n_pages = table.shape[1]
    esc = np.full(n_esc, -1, np.int64)
    bad = 0
    for page in range(n_pages):
        v_start, cnt, base, n, first = (int(v) for v in table[:, page])
        if n == 0 or cnt < 2:
            continue
        n_page_esc = (int(table[4, page + 1]) if page + 1 < n_pages else n_esc) - first
        w_stop = int(table[2, page + 1]) // 64 if page + 1 < n_pages else len(words64)
        n_deltas = cnt - 1
        pos0 = base + HEADER_BITS + width
        end = min(pos0 + n * n_deltas + width * n_page_esc, 64 * w_stop)
        w_begin, w_end = pos0 >> 6, (end + 63) >> 6

        def mask(w):
            acc = int(words64[w]) | ((int(words64[w + 1]) if w + 1 < w_stop else 0) << 64)
            ln = 1
            while ln < n:
                s = min(ln, n - ln)
                acc &= acc >> s
                ln += s
            return acc & _M64

        pos, lim, scan, j0, found, done = pos0, pos0 + n * n_deltas, w_begin, 0, 0, False
        k_lane = [(64 * lane) % n for lane in range(lanes)]
        inv16 = (65536 + n - 1) // n
        inv64 = 0 if n == 1 else (2 ** 64 - 1) // n + 1
        phase = (pos & 63) % n
        n_tiles = -(-(w_end - w_begin) // tile) if w_end > w_begin else 0
        for t in range(n_tiles):
            t_end = min(w_begin + (t + 1) * tile, w_end)
            while not done and scan < t_end:
                hits = []
                for lane in range(lanes):
                    w, hit = scan + lane, 0
                    if w < t_end:
                        b = 64 * w
                        r = (phase - k_lane[lane]) % n if b >= pos else pos - b
                        assert 0 <= r < 64
                        room = lim - b
                        if room > r:
                            hit = mask(w) & _every_nth(r, n)
                            if room < 64:
                                hit &= (1 << room) - 1
                    hits.append(hit)
                src = next((k for k, h in enumerate(hits) if h), None)
                if src is None:
                    step = min(lanes, t_end - scan)
                    phase = (phase - (64 * step) % n) % n
                    scan += step
                    assert phase == (pos - 64 * scan) % n
                    done = 64 * scan >= lim
                    continue
                h = hits[src]
                c = 64 * (scan + src) + (h & -h).bit_length() - 1
                d = c - pos
                j = j0 + (d if n == 1 else (d * inv64) >> 64)
                assert j - j0 == d // n
                if found < n_page_esc:
                    esc[first + found] = v_start + 1 + j
                found += 1
                if found > n_page_esc:
                    done = True
                    break
                pos = c + n + width
                j0 = j + 1
                lim = pos + n * (n_deltas - j0)
                scan = pos >> 6
                x = pos & 63
                phase = x - n * ((x * inv16) >> 16)
                assert phase == x % n
                done = lim <= pos
            if done:
                break
        if found != n_page_esc:
            bad += 1
            esc[first:first + n_page_esc] = v_start + 1 + np.arange(n_page_esc)
    return esc, bad


def _words64(stream):
    return stream.words32.view(np.uint64)


def _malformed(dtype, how):
    """A page of the ``few_escapes`` case whose payload length claims one
    escape more than its markers hold (W/8 zero bytes appended), or one
    fewer (its last raw value cut: the marker before it stays)."""
    payload, n, _ = stored_pages(np.random.default_rng(11), "few_escapes", dtype)[0]
    cut = np.dtype(dtype).itemsize
    payload = payload + bytes(cut) if how == "one_more" else payload[:-cut]
    return payload, n


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", list(CASES))
def test_host_resolution_equals_both_resolvers_and_the_reference(case, dtype):
    """The stream's escape positions (the plain host version of the kernel)
    are those of the candidate scan and of the fixpoint (where it converges)
    on every page, and the JAX package's plans' flags."""
    jax = pytest.importorskip("jax")  # noqa: F841
    from repro.core.fp_delta import fp_delta_plan as j_fp_delta_plan
    from repro.core.pages import PageMeta as JPageMeta
    from repro.core.pages import page_stream_plan as j_page_stream_plan

    pages, ts = _stream(case, dtype)
    dt = np.dtype(dtype)
    jp = [j_page_stream_plan(b, JPageMeta(**raw_meta(len(b), n)), dt, "none")
          if enc == "raw" else j_fp_delta_plan(b, n, dt) for b, n, enc in pages]
    jp = [p for p in jp if p.n_values]
    assert len(jp) == len(ts.plans) == ts.page_table.shape[1]
    assert ts.n_escapes == sum(p.n_escapes for p in jp)
    want = []
    for p, j, v0 in zip(ts.plans, jp, ts.page_table[0].tolist()):
        assert p.n == j.n and p.n_escapes == j.n_escapes
        if p.n == 0 or p.n_values < 2:
            continue
        args = (p.words, HEADER_BITS + p.width, p.n_values - 1, p.n, p.width, p.n_escapes)
        offs, flags = _resolve_escapes_scan(*args)
        assert np.array_equal(flags, j.flags) and np.array_equal(offs, j.offsets)
        fix = _resolve_escapes_fixpoint(*args)
        if fix is not None:
            assert np.array_equal(fix[0], offs) and np.array_equal(fix[1], flags)
        assert int(flags.sum()) == p.n_escapes
        want.append(np.flatnonzero(flags) + v0 + 1)
    want = np.concatenate(want) if want else np.zeros(0, np.int64)
    assert ts.escapes.dtype == np.int32 and np.array_equal(ts.escapes, want)
    if case == "extreme_widths":
        assert [p.n for p in ts.plans] == [1, 8 * dt.itemsize - 1, 8]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_algorithm_equals_host_resolution(case, dtype):
    """The kernel's algorithm, emulated on the stream's words and table at
    tiles of 3 words and 1,024, finds the host's escapes and no bad page."""
    _, ts = _stream(case, dtype)
    for tile in (3, 1024):
        esc, bad = _kernel_walk(_words64(ts), ts.page_table, ts.n_escapes, ts.width, tile)
        assert bad == 0 and np.array_equal(esc, ts.escapes), tile


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("how", ["one_more", "one_fewer"])
def test_kernel_algorithm_counts_malformed_pages(how, dtype):
    """A payload whose length claims another escape count than its markers
    give is one bad page for the kernel's algorithm, its slots filled with
    the page's first positions, and a ``ValueError`` on the host."""
    payload, n = _malformed(dtype, how)
    good = port_plans(stored_pages(np.random.default_rng(11), "few_escapes", dtype), dtype)
    plan = fp_delta_plan(payload, n, np.dtype(dtype))
    assert plan.n_escapes == good[0].n_escapes + (1 if how == "one_more" else -1)
    ts = tfd.build_page_stream([good[1], plan, good[1]])
    esc, bad = _kernel_walk(_words64(ts), ts.page_table, ts.n_escapes, ts.width, 5)
    assert bad == 1
    first = int(ts.page_table[4, 1])
    v0 = int(ts.page_table[0, 1])
    assert np.array_equal(esc[first:first + plan.n_escapes],
                          v0 + 1 + np.arange(plan.n_escapes))
    want = np.flatnonzero(good[1].flags) + 1
    assert np.array_equal(esc[:first], want)
    with pytest.raises(ValueError, match="do not follow its escapes"):
        ts.escapes


def test_planning_and_stream_build_resolve_nothing_on_the_host():
    """Planning pages and building their stream and refine aux reads no
    plan's offsets or flags and no stream's escapes."""
    pages = stored_pages(np.random.default_rng(11), "many_escapes", np.float64)
    obs.enable()
    try:
        plans = port_plans(pages, np.float64)
        ts = tfd.build_page_stream(plans)
        tfd.build_refine_aux(ts, [(0, 1)], np.array([plans[0].n_values]))
        assert ts.n_escapes == sum(p.n_escapes for p in plans) > 0
        assert not any("_resolved" in vars(p) for p in plans)
        assert "escapes" not in vars(ts)
        assert obs.snapshot()["counters"].get("page.resolve.host_pages", 0) == 0
        ts.escapes  # the CPU path's host resolution, one page at a time
        assert obs.snapshot()["counters"]["page.resolve.host_pages"] == len(plans)
    finally:
        obs.disable()


# ------------------------------------------------------------------ the card
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", [*CASES, "random_4m"])
def test_escape_resolve_kernel_matches_host(card, case, dtype):
    """The card's escape positions equal the host resolution on every case,
    with no bad page, and the stream's host escapes are never computed on
    the way."""
    _, ts = _stream(case, dtype)
    launches = fkernel.escape_resolve.launches
    ds = tfd.stream_from_numpy(ts, device=card)
    assert fkernel.escape_resolve.launches == launches + 1
    assert "escapes" not in vars(ts) and not any("_resolved" in vars(p) for p in ts.plans)
    words = ds.words32
    table = torch.from_numpy(ts.page_table).to(card)
    esc, bad = fkernel.escape_resolve(words, table, ts.n_escapes, ts.width)
    torch.cuda.synchronize()
    assert int(bad.item()) == 0 and int(ds.bad.item()) == 0
    assert esc.dtype == torch.int32 and torch.equal(esc.cpu(), torch.from_numpy(ts.escapes))
    want = fops.expand_stream_ref(ts)
    for got, w in zip((ds.tok_off, ds.nbits, ds.anchor), want):
        assert torch.equal(got.cpu(), torch.from_numpy(w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("how", ["one_more", "one_fewer"])
def test_card_read_refuses_malformed_payload(card, how, dtype):
    """A payload whose length claims another escape count than its markers
    give is one bad page on the card, its slots its first positions, and
    every decode of it raises ``ValueError``."""
    payload, n = _malformed(dtype, how)
    good = port_plans(stored_pages(np.random.default_rng(11), "few_escapes", dtype), dtype)
    plan = fp_delta_plan(payload, n, np.dtype(dtype))
    ts = tfd.build_page_stream([good[1], plan, good[1]])
    ds = tfd.stream_from_numpy(ts, device=card)
    assert int(ds.bad.item()) == 1
    with pytest.raises(ValueError, match="do not follow their escapes"):
        tfd.decode_page_stream(ts, device=card)
    with pytest.raises(ValueError, match="do not follow their escapes"):
        tfd.decode_pages([good[0], plan], device=card)
    with pytest.raises(ValueError, match="do not follow its escapes"):
        tfd.decode_page_stream(ts, device="cpu")


@pytest.mark.cuda
def test_bbox_read_on_card_resolves_escapes_on_card(card, tmp_path):
    """A traced bbox read on the card resolves every page's escapes there
    (one ``device.resolve_launch`` a launch, in ``rg.launch``) and none on
    the host, and gives the CPU path's survivors and bits."""
    cols = porto_taxi_like(n_traj=3000)
    path = tmp_path / "pt.spqf"
    write_file(path, columns=cols, sort="hilbert", page_values=4096, row_group_records=1000)
    bbox = (-8.7, 41.1, -8.6, 41.2)
    with SpatialParquetReader(path) as r:
        want = r.read_columnar(bbox=bbox, refine=True, device="cpu")
        tracer = obs.enable()
        try:
            got = r.read_columnar(bbox=bbox, refine=True, device="cuda")
        finally:
            obs.disable()
    counters = obs.snapshot()["counters"]
    assert counters.get("page.resolve.host_pages", 0) == 0
    assert counters["page.resolve.device_pages"] == 2 * got[2].pages_read > 0
    spans = tracer.spans()
    names = {s["args"]["span_id"]: s["name"] for s in spans}
    resolve = [s for s in spans if s["name"] == "device.resolve_launch"]
    launches = [s for s in spans if s["name"] == "device.expand_launch"]
    assert resolve and len(resolve) == len(launches)
    assert all(names.get(s["args"]["parent_id"]) == "rg.launch" for s in resolve)
    assert got[2].records_returned == want[2].records_returned > 0
    assert np.array_equal(got[0].x.view(np.int64), want[0].x.view(np.int64))
    assert np.array_equal(got[0].y.view(np.int64), want[0].y.view(np.int64))


@pytest.mark.cuda
def test_escape_resolve_on_one_long_page(card):
    """One page of 3 M values with an escape every 64 values or so: the walk
    crosses thousands of tiles and finds every escape."""
    rng = np.random.default_rng(5)
    x = np.cumsum(rng.normal(0, 1e-5, 3_000_000)) + 40.7
    x[rng.integers(1, len(x), len(x) // 64)] = rng.normal(0, 1e3, len(x) // 64)
    payload, _ = fp_delta_encode(x)
    plan = fp_delta_plan(payload, len(x), np.dtype(np.float64))
    ts = tfd.build_page_stream([plan])
    ds = tfd.stream_from_numpy(ts, device=card)
    table = torch.from_numpy(ts.page_table).to(card)
    esc, bad = fkernel.escape_resolve(ds.words32, table, ts.n_escapes, ts.width)
    torch.cuda.synchronize()
    assert int(bad.item()) == 0
    assert torch.equal(esc.cpu(), torch.from_numpy(ts.escapes))
