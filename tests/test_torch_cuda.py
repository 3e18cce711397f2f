"""Card-only tests: each CUDA kernel against its plain PyTorch version.

These import only the port (no JAX), so they run on a machine with a card
and no JAX: ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Each test decides inside itself whether a card exists and skips without
one. Inputs are made with numpy from a seed; tolerance: exact bit patterns,
except for flash attention, whose tolerances are stated at its tests.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.fp_delta import fp_delta_encode, fp_delta_plan
from repro_torch.core.pages import PageMeta, page_stream_plan
from repro_torch.core.reader import SpatialParquetReader
from repro_torch.core.writer import write_file
from repro_torch.data.synthetic import porto_taxi_like
from repro_torch.kernels import fp_delta as tfd
from repro_torch.kernels import minmax as tmm
from repro_torch.kernels.fp_delta import kernel as fkernel, ref as fref
from repro_torch.kernels.minmax import kernel as mkernel, ref as mref
from repro_torch.models import flatten_with_paths

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pages(rng, dtype, n=5000):
    """Escape-free, escaped, all-escape and special-value pages, plus a raw page."""
    smooth = (np.cumsum(rng.normal(0, 1e-4, n)) + 40.7).astype(dtype)
    sparse = smooth.copy()
    sparse[rng.integers(0, n, 20)] = rng.normal(0, 1e30, 20).astype(dtype)
    uint = np.uint32 if np.dtype(dtype).itemsize == 4 else np.uint64
    dense = rng.integers(0, np.iinfo(uint).max, n, dtype=uint, endpoint=True).view(dtype)
    special = smooth.copy()
    pool = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0,
                     np.finfo(dtype).smallest_subnormal], dtype)
    special[rng.integers(0, n, 200)] = pool[rng.integers(0, len(pool), 200)]
    plans = []
    for p in (smooth, sparse, dense, special):
        payload, _ = fp_delta_encode(p)
        plans.append(fp_delta_plan(payload, len(p), np.dtype(dtype)))
    raw = special[::-1].copy()
    meta = PageMeta(0, raw.nbytes, len(raw), 0, 0, 0.0, 0.0, "raw", 0, 0)
    plans.append(page_stream_plan(raw.tobytes(), meta, np.dtype(dtype), "none"))
    return [smooth, sparse, dense, special, raw], plans


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_decode_kernel_matches_plain(card, rng, dtype):
    pages, plans = _pages(rng, dtype)
    stream = tfd.build_page_stream(plans)
    ds = tfd.stream_from_numpy(stream, device=card)
    args = (ds.words32, ds.tok_off, ds.nbits, ds.anchor, ds.width)
    got = fkernel.decode_stream(*args)
    assert torch.equal(got, fref.decode_stream_ref(*args))
    want = np.concatenate(pages)
    assert np.array_equal(got[: len(want)].cpu().numpy(), want.view(got.cpu().numpy().dtype))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_refine_kernel_matches_plain(card, rng, dtype):
    pages, plans = _pages(rng, dtype)
    # pair the pages up as (x, y) of records of random sizes, empties included
    n = len(pages[0])
    counts = rng.integers(0, 60, n)
    counts = counts[np.cumsum(counts) <= n]
    counts = np.append(counts, n - counts.sum())
    stream = tfd.build_page_stream(plans[:2])
    aux = tfd.build_refine_aux(stream, [(0, len(counts))], counts)
    ds = tfd.stream_from_numpy(stream, aux, device=card)
    bits = tfd.decode_stream_bits(ds)
    for bbox in ((40.6, 40.6, 40.75, 40.8), (-np.inf, -np.inf, np.inf, np.inf)):
        q = tmm.keys64(tmm.bbox_query_keys(bbox, np.dtype(dtype)))
        args = (bits, ds.x_start, ds.y_start, ds.counts, ds.valid, q, ds.width)
        k1, m1 = mkernel.segminmax_refine(*args)
        k2, m2 = mref.segminmax_refine_ref(*args)
        assert torch.equal(k1, k2) and torch.equal(m1, m2), bbox


def test_page_minmax_kernel_matches_plain(card, rng):
    tiny = np.finfo(np.float32).smallest_subnormal
    pages = [np.array([0.0, -0.0], np.float32), np.array([-0.0, 0.0], np.float32),
             np.array([1.0, np.nan, -3.0], np.float32), np.full(5, np.nan, np.float32),
             np.zeros(0, np.float32), np.array([np.inf, -np.inf, tiny, -tiny], np.float32),
             np.array([-tiny, -0.0], np.float32), rng.normal(0, 1e3, 70_000).astype(np.float32)]
    v = torch.from_numpy(np.concatenate(pages)).to(card)
    b = torch.from_numpy(np.concatenate([[0], np.cumsum([len(p) for p in pages])])
                         .astype(np.int64)).to(card)
    for got, want in zip(mkernel.page_minmax(v, b), mref.page_minmax_ref(v, b)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _page_cases(rng):
    """(name, values, bounds) for kernel 3: one 1<<20-value page, 10,000
    empty pages among real ones, bounds that start and end off 16-byte
    boundaries (and a values view off one), NaN, ±0 and denormal pages."""
    tiny = np.finfo(np.float32).smallest_subnormal
    out = []
    v = rng.normal(-3, 1e3, 1 << 20).astype(np.float32)
    out.append(("one_page_1M", v, np.array([0, v.size], np.int64)))
    sizes = np.zeros(10_400, np.int64)
    sizes[rng.choice(sizes.size, 400, replace=False)] = rng.integers(1, 6000, 400)
    v = rng.normal(5, 1e2, int(sizes.sum())).astype(np.float32)
    v[rng.integers(0, v.size, 300)] = np.array([np.nan, -0.0, 0.0, tiny, -tiny, np.inf],
                                               np.float32)[rng.integers(0, 6, 300)]
    out.append(("empty_10000", v, np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)))
    v = rng.normal(0, 1, 70_001).astype(np.float32)
    v[[5, 9, 4099, 4100]] = [-0.0, 0.0, 0.0, -0.0]
    out.append(("misaligned_bounds", v,
                np.array([3, 9, 4098, 4101, 4101, 30_001, 69_998], np.int64)))
    return out


def test_page_minmax_kernel_large_empty_and_misaligned(card, rng):
    """Kernel 3 on a 1<<20-value page (one block), 10,000 empty pages and
    ragged bounds, with the values pointer 0, 4 and 12 bytes off 16."""
    for name, v, b in _page_cases(rng):
        vt = torch.from_numpy(v).to(card)
        bt = torch.from_numpy(b).to(card)
        for off in (0, 1, 3):          # the values pointer 0, 4 and 12 bytes off 16
            if off:
                buf = torch.empty(v.size + off, dtype=torch.float32, device=card)
                buf[off:] = vt
                vv = buf[off:]
            else:
                vv = vt
            got = mkernel.page_minmax(vv, bt)
            want = mref.page_minmax_ref(vv, bt)
            for g, w in zip(got, want):
                assert torch.equal(g.view(torch.int32), w.view(torch.int32)), (name, off)


def test_page_minmax_kernel_back_to_back_and_threads(card, rng):
    """Calls queued back to back and four threads at once each get their
    own outputs and agree with the plain version."""
    from concurrent.futures import ThreadPoolExecutor

    cases = [(torch.from_numpy(v).to(card), torch.from_numpy(b).to(card))
             for _, v, b in _page_cases(rng)]
    wants = [mref.page_minmax_ref(v, b) for v, b in cases]
    outs = [mkernel.page_minmax(v, b) for v, b in cases]
    for got, want in zip(outs, wants):
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    with ThreadPoolExecutor(max_workers=4) as pool:
        for _ in range(3):
            outs = list(pool.map(lambda c: mkernel.page_minmax(*c), cases + cases[:1]))
            torch.cuda.synchronize()
            for got, want in zip(outs, wants + wants[:1]):
                for g, w in zip(got, want):
                    assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def test_page_minmax_kernel_on_two_streams(card, rng):
    """Calls alternating between two streams agree with the plain version."""
    cases = [(torch.from_numpy(v).to(card), torch.from_numpy(b).to(card))
             for _, v, b in _page_cases(rng)]
    wants = [mref.page_minmax_ref(v, b) for v, b in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for r in range(4):
        for i, (v, b) in enumerate(cases):
            with torch.cuda.stream(streams[(r + i) % 2]):
                outs.append((i, mkernel.page_minmax(v, b)))
    torch.cuda.synchronize()
    for i, got in outs:
        for g, w in zip(got, wants[i]):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def test_main_path_on_card_matches_host(card, tmp_path):
    """write_file + bbox-refined reads on the card equal the numpy path."""
    cols = porto_taxi_like(n_traj=3000)
    n = cols.n_records
    extra = {"d": np.linspace(0, 900, n).astype(np.float32)}
    path = tmp_path / "pt.spqf"
    counts0 = (fkernel.decode_stream.launches, mkernel.segminmax_refine.launches,
               mkernel.page_minmax.launches)
    write_file(path, columns=cols, extra=extra, extra_schema={"d": "<f4"},
               sort="hilbert", page_values=4096, row_group_records=1000)
    with SpatialParquetReader(path) as r:
        bbox = (-8.7, 41.1, -8.6, 41.2)
        got = r.read_columnar(bbox=bbox, refine=True)
        want = r.read_columnar(bbox=bbox, refine=True, device="host")
    assert got[2].records_returned == want[2].records_returned > 0
    assert np.array_equal(got[0].x.view(np.int64), want[0].x.view(np.int64))
    assert np.array_equal(got[0].y.view(np.int64), want[0].y.view(np.int64))
    assert np.array_equal(got[1]["d"].view(np.int32), want[1]["d"].view(np.int32))
    counts1 = (fkernel.decode_stream.launches, mkernel.segminmax_refine.launches,
               mkernel.page_minmax.launches)
    assert all(c1 > c0 for c0, c1 in zip(counts0, counts1))


def _anchor_free_plan(rng, dtype, n):
    """One fp_delta page of ``n`` values whose bit patterns step by at most
    3000: no escapes, so its only anchor is its first value and the carry
    runs through every tile of the stream."""
    it = np.int32 if np.dtype(dtype).itemsize == 4 else np.int64
    base = np.array([40.7], dtype).view(it)[0]
    x = (base + np.cumsum(rng.integers(-3000, 3000, n))).astype(it).view(dtype)
    payload, _ = fp_delta_encode(x)
    plan = fp_delta_plan(payload, n, np.dtype(dtype))
    assert int(np.sum(plan.flags)) == 0
    return x, plan


def _decode_both(ds):
    args = (ds.words32, ds.tok_off, ds.nbits, ds.anchor, ds.width)
    return fkernel.decode_stream(*args), fref.decode_stream_ref(*args)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_decode_kernel_long_carry_chain(card, rng, dtype):
    """4.2 M values with one anchor: the look-back chains over about 2,000
    tiles of real values (4,096 tiles with the padding)."""
    x, plan = _anchor_free_plan(rng, dtype, 4_200_000)
    ds = tfd.stream_from_numpy(tfd.build_page_stream([plan]), device=card)
    assert int(ds.anchor.reshape(-1)[: len(x)].sum()) == 1
    got, want = _decode_both(ds)
    assert torch.equal(got, want)
    assert np.array_equal(got[: len(x)].cpu().numpy(), x.view(got.cpu().numpy().dtype))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_decode_kernel_all_anchors(card, rng, dtype):
    """Raw pages only: every position is an anchor, every tile inclusive at once."""
    raw = rng.normal(-8.6, 1.0, 300_000).astype(dtype)
    meta = PageMeta(0, raw.nbytes, len(raw), 0, 0, 0.0, 0.0, "raw", 0, 0)
    plan = page_stream_plan(raw.tobytes(), meta, np.dtype(dtype), "none")
    ds = tfd.stream_from_numpy(tfd.build_page_stream([plan, plan]), device=card)
    assert bool((ds.anchor != 0).all())
    got, want = _decode_both(ds)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n_blocks", [1, 3, 1057, 2115])
def test_decode_kernel_tile_counts(card, rng, dtype, n_blocks):
    """One stream block (half a tile), odd block counts (a partial last
    tile), and tile counts (529, 1058) that no persistent grid of whole
    SMs times blocks per SM divides: the first rows of a longer stream."""
    x, plan = _anchor_free_plan(rng, dtype, 2200 * 1024)
    _, plans = _pages(rng, dtype, 3000)
    s = tfd.build_page_stream(plans + [plan])
    ds = tfd.stream_from_numpy(s, device=card)
    args = [t[:n_blocks].contiguous() for t in (ds.tok_off, ds.nbits, ds.anchor)]
    got = fkernel.decode_stream(ds.words32, *args, ds.width)
    assert got.shape == (n_blocks * 1024,)
    assert torch.equal(got, fref.decode_stream_ref(ds.words32, *args, ds.width))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_decode_kernel_back_to_back_and_threads(card, rng, dtype):
    """Two calls queued back to back without a synchronise, then four
    threads calling at once (the scanner's pattern): each call zeroes its
    own tile statuses on its stream, so none sees another's."""
    from concurrent.futures import ThreadPoolExecutor

    streams = []
    for n in (1_500_000, 900_000, 2_300_000, 40_000):
        _, plan = _anchor_free_plan(rng, dtype, n)
        _, plans = _pages(rng, dtype, 4000)
        streams.append(tfd.stream_from_numpy(tfd.build_page_stream(plans + [plan]),
                                             device=card))
    a, b = (fkernel.decode_stream(d.words32, d.tok_off, d.nbits, d.anchor, d.width)
            for d in streams[:2])
    torch.cuda.synchronize()
    for got, d in ((a, streams[0]), (b, streams[1])):
        assert torch.equal(got, _decode_both(d)[1])
    with ThreadPoolExecutor(max_workers=4) as pool:
        for _ in range(3):
            outs = list(pool.map(lambda d: fkernel.decode_stream(
                d.words32, d.tok_off, d.nbits, d.anchor, d.width), streams))
            torch.cuda.synchronize()
            for got, d in zip(outs, streams):
                assert torch.equal(got, _decode_both(d)[1])


def test_decode_kernel_copies_misaligned_operands(card, rng):
    """Operands that are contiguous but not 16-byte aligned are copied
    before the bulk loads, not refused."""
    _, plans = _pages(rng, np.float64, 3000)
    ds = tfd.stream_from_numpy(tfd.build_page_stream(plans), device=card)
    shifted = []
    for t in (ds.tok_off, ds.nbits, ds.anchor):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16
        shifted.append(view)
    got = fkernel.decode_stream(ds.words32, *shifted, ds.width)
    assert torch.equal(got, fref.decode_stream_ref(ds.words32, *shifted, ds.width))


# ---------------------------------------------------------- miniblock codec
def _codec_blocks(rng):
    """(n, 1024) uint32 blocks: smooth with outliers, random patterns, a
    constant block, and one block landing on each packing width."""
    smooth = (np.cumsum(rng.normal(0, 1e-4, 8 * 1024)) + 41).astype(np.float32)
    smooth[rng.integers(0, smooth.size, 300)] = rng.normal(0, 1e30, 300).astype(np.float32)
    blocks = [smooth.view(np.uint32).reshape(-1, 1024),
              rng.integers(0, 2 ** 32, (3, 1024), dtype=np.uint64).astype(np.uint32),
              np.full((1, 1024), np.float32(2.5)).view(np.uint32)]
    for w in fref.WIDTHS:
        z = rng.integers(1 << (w - 1), 1 << w, 1024, dtype=np.uint64).astype(np.uint32)
        z[0] = 0
        d = (z >> np.uint32(1)) ^ (np.uint32(0) - (z & np.uint32(1)))
        blocks.append((np.uint32(7) + np.cumsum(d, dtype=np.uint32))[None])
    return np.concatenate(blocks)


def test_miniblock_kernels_match_plain(card, rng):
    x = torch.from_numpy(_codec_blocks(rng).view(np.float32)).to(card)
    n0 = (fkernel.encode_blocks.launches, fkernel.decode_blocks.launches)
    got = fkernel.encode_blocks(x)
    want = fref.encode_blocks_ref(x)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert sorted(set(got[1].tolist())) == [0, *fref.WIDTHS]
    back = fkernel.decode_blocks(*got)
    assert torch.equal(back.view(torch.int32), fref.decode_blocks_ref(*got).view(torch.int32))
    assert torch.equal(back.view(torch.int32), x.view(torch.int32))
    assert (fkernel.encode_blocks.launches, fkernel.decode_blocks.launches) == (n0[0] + 1,
                                                                                 n0[1] + 1)


def _adversarial_blocks(rng):
    """(n, 1024) uint32 blocks: a block at every width, 64 and 65 outliers
    (width 4 with 64 exceptions; 65 push it to 20), and a cost tie
    (cost(1) = 1024 + 48 * 64 = cost(4): width 1 is kept)."""
    def from_zig(z):
        z = np.asarray(z, np.uint32).copy()
        z[0] = 0
        d = (z >> np.uint32(1)) ^ (np.uint32(0) - (z & np.uint32(1)))
        return np.uint32(0x42240000) + np.cumsum(d, dtype=np.uint32)

    def bits(lo, hi, n):
        return rng.integers(lo, hi, n, dtype=np.uint64).astype(np.uint32)

    blocks = [np.full(1024, np.float32(2.5)).view(np.uint32)]
    blocks += [from_zig(bits(1 << (w - 1), 1 << w, 1024)) for w in fref.WIDTHS]
    for k in (64, 65):
        z = bits(8, 16, 1024)
        z[rng.choice(np.arange(1, 1024), k, replace=False)] = bits(1 << 19, 1 << 20, k)
        blocks.append(from_zig(z))
    z = np.ones(1024, np.uint32)
    z[rng.choice(np.arange(1, 1024), 64, replace=False)] = bits(8, 16, 64)
    blocks.append(from_zig(z))
    return np.stack(blocks)


@pytest.mark.parametrize("n_blocks", [1, 7, 5000])
def test_encode_kernel_block_counts(card, rng, n_blocks):
    """1 and 7 miniblocks (fewer than one persistent warp each), and 5,000
    (more than the grid's warps hold at once: every warp's ring wraps),
    drawn from the adversarial blocks, smooth blocks with outliers and
    random patterns; all six outputs equal the plain version's."""
    adv = _adversarial_blocks(rng)
    pool = np.concatenate([adv, _codec_blocks(rng)])
    x = pool[rng.integers(0, len(pool), n_blocks)]
    x[: min(n_blocks, len(adv))] = adv[: min(n_blocks, len(adv))]
    xt = torch.from_numpy(x.view(np.float32)).to(card)
    got = fkernel.encode_blocks(xt)
    want = fref.encode_blocks_ref(xt)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if n_blocks >= len(adv):
        w, c = got[1][: len(adv)].tolist(), got[5][: len(adv)].tolist()
        assert w[: 1 + len(fref.WIDTHS)] == [0, *fref.WIDTHS]
        assert (w[-3], c[-3]) == (4, 64) and (w[-2], c[-2]) == (20, 0)
        assert (w[-1], c[-1]) == (1, 64)
    back = fkernel.decode_blocks(*got)
    assert torch.equal(back.view(torch.int32), xt.view(torch.int32))


def _malformed_streams(rng, card):
    """Decode inputs that encode never writes, as (name, six int32 arrays
    on the card): repeated live slots (summing, wrapping), positions -1,
    1024 and 65535, exception counts -1, 0, 64 and 255, widths outside the
    format."""
    x = (np.cumsum(rng.normal(0, 1e-4, 6 * 1024)) + 41).astype(np.float32)
    x[rng.integers(0, x.size, 100)] = rng.normal(0, 1e30, 100).astype(np.float32)
    base = [t.clone() for t in fkernel.encode_blocks(torch.from_numpy(x.reshape(6, 1024)).to(card))]

    def i32(a):
        return torch.tensor(np.asarray(a, np.int64).astype(np.int32), device=card)

    out = []
    a = [t.clone() for t in base]
    a[3][0, :5] = i32([17, 17, 17, 900, 900])
    a[4][0, :5] = i32([5, 9, -2, 2 ** 31 - 1, 2 ** 31 - 1])
    a[5][0] = 5
    a[3][1, :] = 3                                   # 64 live slots on one position
    a[4][1, :] = i32(rng.integers(-2 ** 31, 2 ** 31, 64))
    a[5][1] = 64
    out.append(("duplicates", a))
    a = [t.clone() for t in base]
    a[3][2, :6] = i32([-1, 1024, 65535, 0, 1023, -2 ** 31])
    a[4][2, :6] = i32(rng.integers(-2 ** 31, 2 ** 31, 6))
    a[5][2] = 6
    out.append(("out_of_range", a))
    for c in (-1, 0, 64, 255):
        a = [t.clone() for t in base]
        a[3][:] = i32(rng.integers(0, 1024, (6, 64)))
        a[3][:, 10:20] = 500
        a[4][:] = i32(rng.integers(-2 ** 31, 2 ** 31, (6, 64)))
        a[5][:] = c
        out.append((f"count_{c}", a))
    a = [t.clone() for t in base]
    a[1][:] = i32([5, 33, -1, 7, 255, 32])
    out.append(("unknown_widths", a))
    return out


def test_miniblock_decode_on_malformed_streams(card, rng):
    """Streams outside encode's contract: the kernel equals the plain
    version bit for bit (repeated live slots sum mod 2^32, as the
    reference's inject_exceptions does)."""
    for name, args in _malformed_streams(rng, card):
        got = fkernel.decode_blocks(*args)
        want = fref.decode_blocks_ref(*args)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), name
    # the same sums written as one slot each: 5 + 9 - 2 at 17, and
    # 2 * (2^31 - 1) = -2 mod 2^32 at 900
    name, args = _malformed_streams(np.random.default_rng(5), card)[0]
    one = [t.clone() for t in args]
    one[3][0, :2] = torch.tensor([17, 900], dtype=torch.int32, device=card)
    one[4][0, :2] = torch.tensor([12, -2], dtype=torch.int32, device=card)
    one[5][0] = 2
    assert torch.equal(fkernel.decode_blocks(*args).view(torch.int32)[0],
                       fkernel.decode_blocks(*one).view(torch.int32)[0])


def _decode_inputs(rng, card, n_blocks):
    """Encoded blocks drawn from the adversarial and codec blocks, encoded
    by the plain version, on the card."""
    pool = np.concatenate([_adversarial_blocks(rng), _codec_blocks(rng)])
    x = torch.from_numpy(pool[rng.integers(0, len(pool), n_blocks)].view(np.float32))
    return [t.to(card) for t in fref.encode_blocks_ref(x)], x


@pytest.mark.parametrize("n_blocks", [1, 7, 5000, 80189])
def test_miniblock_decode_block_counts(card, rng, n_blocks):
    """1 and 7 miniblocks (fewer than one block of warps), 5,000 and the
    codec path's 80,189 (every warp's ring wraps many times)."""
    args, x = _decode_inputs(rng, card, n_blocks)
    got = fkernel.decode_blocks(*args)
    assert torch.equal(got.view(torch.int32), fref.decode_blocks_ref(*args).view(torch.int32))
    assert torch.equal(got.view(torch.int32).cpu(), x.view(torch.int32))


def test_miniblock_decode_back_to_back_and_threads(card, rng):
    """Two calls queued back to back, then four threads at once."""
    from concurrent.futures import ThreadPoolExecutor

    inputs = [_decode_inputs(rng, card, n)[0] for n in (3000, 77, 5000, 1)]
    inputs += [a for _, a in _malformed_streams(rng, card)[:2]]
    wants = [fref.decode_blocks_ref(*a).view(torch.int32) for a in inputs]
    outs = [fkernel.decode_blocks(*a) for a in inputs[:2]]
    for got, want in zip(outs, wants):
        assert torch.equal(got.view(torch.int32), want)
    with ThreadPoolExecutor(max_workers=4) as pool:
        for _ in range(3):
            outs = list(pool.map(lambda a: fkernel.decode_blocks(*a), inputs))
            torch.cuda.synchronize()
            for got, want in zip(outs, wants):
                assert torch.equal(got.view(torch.int32), want)


def test_miniblock_decode_rejects_misaligned_operands(card, rng):
    args, _ = _decode_inputs(rng, card, 4)
    flat = torch.zeros(4 * 1024 + 1, dtype=torch.int32, device=card)
    shifted = flat[1:].view(4, 1024)
    shifted.copy_(args[0])
    with pytest.raises(ValueError, match="16-byte aligned"):
        fkernel.decode_blocks(shifted, *args[1:])


def test_codec_round_trip_on_card(card, rng):
    x = (np.cumsum(rng.normal(0, 1e-3, 50_000)) - 8.6).astype(np.float32).reshape(50, -1)
    buf = tfd.compress_array(x)
    assert buf == tfd.compress_array(x, device="cpu")
    y = tfd.decompress_array(buf, x.shape)
    assert np.array_equal(y.view(np.int32), x.view(np.int32))


def test_dataset_scan_on_card_matches_host(card, tmp_path):
    """write_dataset + scans on the card equal the numpy path, and go
    through kernels 1-3."""
    from repro_torch.core.filters import Range
    from repro_torch.dataset import SpatialDatasetScanner, write_dataset

    cols = porto_taxi_like(n_traj=3000)
    extra = {"d": np.linspace(0, 900, cols.n_records).astype(np.float32)}
    counts0 = (fkernel.decode_stream.launches, mkernel.segminmax_refine.launches,
               mkernel.page_minmax.launches)
    write_dataset(tmp_path / "lake", columns=cols, extra=extra, n_shards=4, page_values=4096)
    sc = SpatialDatasetScanner(tmp_path / "lake", max_workers=4)
    bbox = (-8.7, 41.1, -8.6, 41.2)
    for kw in (dict(bbox=bbox, refine=True), dict(bbox=bbox, refine=True, filter=Range("d", 100, 500)),
               dict(bbox=bbox, refine=True, keep_on_device=True)):
        got = sc.scan(**kw)
        want = sc.scan(device="host", **{k: v for k, v in kw.items() if k != "keep_on_device"})
        assert got[2].records_returned == want[2].records_returned > 0
        g = got[0].coords_to_host()
        assert np.array_equal(g.x.view(np.int64), want[0].x.view(np.int64))
        assert np.array_equal(g.y.view(np.int64), want[0].y.view(np.int64))
        assert np.array_equal(got[1]["d"].view(np.int32), want[1]["d"].view(np.int32))
    counts1 = (fkernel.decode_stream.launches, mkernel.segminmax_refine.launches,
               mkernel.page_minmax.launches)
    assert all(c1 > c0 for c0, c1 in zip(counts0, counts1))


def _serve_lake(root):
    from repro_torch.dataset import write_dataset

    cols = porto_taxi_like(n_traj=3000, seed=11)
    write_dataset(root, columns=cols, extra={"tid": np.arange(cols.n_records, dtype=np.int64)},
                  n_shards=4, page_values=4096, device="cpu")
    return root


def test_query_server_on_card_matches_host(card, tmp_path):
    """Two waves of the same boxes (plus no box, a NaN box and a filter) on
    the card equal the numpy server; the first goes through kernels 1-2,
    the second is served from the card-resident cache alone, and
    ``invalidate`` gives the cache's device memory back."""
    from repro_torch.core.filters import Range
    from repro_torch.dataset import SpatialDatasetScanner
    from repro_torch.serve import SpatialQueryServer

    sc = SpatialDatasetScanner(_serve_lake(tmp_path / "lake"))
    subs = [((-8.7, 41.1, -8.6, 41.2), None), ((-8.65, 41.12, -8.55, 41.2), None),
            (None, None), ((np.nan, 41.1, -8.6, 41.2), None),
            ((-8.7, 41.1, -8.6, 41.2), Range("tid", 100, 2000))]
    with SpatialQueryServer(sc, device="host", max_wave=64) as host:
        want = [host.submit(b, filter=f) for b, f in subs]
        host.run()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    with SpatialQueryServer(sc, max_wave=64) as srv:
        assert srv.device == "cuda"
        for wave in range(2):
            counts0 = (fkernel.decode_stream.launches, mkernel.segminmax_refine.launches)
            decodes0 = srv.rg_decodes
            got = [srv.submit(b, filter=f) for b, f in subs]
            srv.run()
            counts1 = (fkernel.decode_stream.launches, mkernel.segminmax_refine.launches)
            if wave == 0:
                assert all(c1 > c0 for c0, c1 in zip(counts0, counts1))
            else:
                assert counts1 == counts0 and srv.rg_decodes == decodes0
            for g, w in zip(got, want):
                assert g.stats.records_returned == w.stats.records_returned
                if w.geo is None:
                    assert g.geo is None
                    continue
                assert np.array_equal(g.geo.x.view(np.int64), w.geo.x.view(np.int64))
                assert np.array_equal(g.geo.y.view(np.int64), w.geo.y.view(np.int64))
                assert np.array_equal(g.extras["tid"], w.extras["tid"])
        assert torch.cuda.memory_allocated() > mem0
        srv.invalidate()
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() == mem0


def test_batcher_on_card_matches_host(card, tmp_path):
    """The data feed's batches on the card equal the numpy path's, and its
    shard reads go through kernels 1-2 on the prefetch thread."""
    from repro_torch.data.pipeline import Prefetcher, TrajectoryBatcher
    from repro_torch.data.tokenizer import GeoTokenizer

    root = _serve_lake(tmp_path / "lake")
    box = (-8.68, 41.12, -8.58, 41.2)

    def batches(device):
        b = TrajectoryBatcher([root], GeoTokenizer((-8.70, 41.10, -8.50, 41.25), order=6),
                              seq_len=128, global_batch=16, bbox=box, loop=False,
                              seed=0, device=device)
        return [x["tokens"] for x in Prefetcher(b)]

    counts0 = (fkernel.decode_stream.launches, mkernel.segminmax_refine.launches)
    got = batches("cuda")
    counts1 = (fkernel.decode_stream.launches, mkernel.segminmax_refine.launches)
    want = batches("host")
    assert len(got) == len(want) > 0
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert all(c1 > c0 for c0, c1 in zip(counts0, counts1))


# ---------------------------------------------------------- flash attention
def _within_bf16_bound(got, q, k, v, causal):
    """Hold a bf16 output to the float32 plain version on the same
    (bf16-valued) inputs, element by element:

        |got - want32| <= 2^-8 |want32| + (2^-8 + 2^-15) A + 1e-5,

    A = the plain version's softmax-weighted mean of |v|. The sm90 kernel
    rounds P to bf16 before P.V (as the reference's oracle and SDPA's flash
    backend do), which moves each term by at most u = 2^-8 of itself and the
    sum by at most u * A; the output's one rounding adds u * |want32|;
    2^-15 * A covers the second-order terms and 1e-5 float32 sum order.
    ``tests/test_torch_flash_attention.py`` holds an emulation of this
    rounding to the same bound."""
    from repro_torch.kernels.flash_attention import attention_plain

    want = attention_plain(q.float(), k.float(), v.float(), causal=causal)
    a = attention_plain(q.float(), k.float(), v.float().abs(), causal=causal)
    err = (got.float() - want).abs()
    tol = 2.0 ** -8 * want.abs() + (2.0 ** -8 + 2.0 ** -15) * a + 1e-5
    return bool((err <= tol).all()), float((err / tol).max())


def _launches():
    from repro_torch.kernels.flash_attention import kernel

    return kernel.flash_attention_sm90.launches, kernel.flash_attention_f32.launches


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,causal", [
    (2, 4, 4, 128, 128, True),
    (1, 8, 2, 256, 256, True),     # GQA
    (1, 4, 4, 128, 384, True),     # decode-aligned rectangular
    (1, 2, 2, 1, 128, True),       # single-token decode
    (1, 6, 3, 100, 256, True),     # ragged q, GQA
    (2, 2, 2, 128, 128, False),    # non-causal
])
def test_flash_kernel_matches_plain(card, rng, dtype, tol, d, b, hq, hkv, sq, sk, causal):
    """Tolerance: the reference's (2e-5 in float32 for sum order; 3e-2 in
    bf16, where the plain version rounds P to bf16 before P.V). In bf16 that
    3e-2 is about as large as a typical output, so each element is also
    held to the float32 plain version by :func:`_within_bf16_bound`. bf16
    goes through the sm90 kernel, float32 through the split-TF32 one."""
    from repro_torch.kernels.flash_attention import attention, attention_plain

    q, k, v = (torch.from_numpy(rng.normal(0, 1, (b, h, s, d)).astype(np.float32))
               .to(card, dtype) for h, s in ((hq, sq), (hkv, sk), (hkv, sk)))
    torch.backends.cuda.matmul.allow_tf32 = False
    n0 = _launches()
    got = attention(q, k, v, causal=causal)
    want = attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert _launches() == (n0[0] + bf16, n0[1] + (not bf16))
    assert got.dtype == dtype and got.shape == (b, hq, sq, d)
    assert float((got.float() - want.float()).abs().max()) < tol
    if bf16:
        ok, share = _within_bf16_bound(got, q, k, v, causal)
        assert ok, share


@pytest.mark.parametrize("b,hq,hkv,sq,sk,causal,layout", [
    (1, 2, 2, 1024, 1024, True, "bhsd"),    # eight key tiles: four rounds of the ring
    (1, 2, 2, 2048, 2048, True, "bhsd"),    # sixteen key tiles, sixteen query tiles
    (1, 32, 8, 1024, 1024, True, "bsh"),    # qwen3-8b's GQA 32/8, as the model passes views
    (1, 2, 2, 1000, 1024, True, "bhsd"),    # ragged q: the first query tile starts at -24
    (1, 2, 2, 1024, 1024, False, "bhsd"),   # non-causal: no diagonal tile
    (2, 8, 2, 512, 512, True, "bsh"),       # strided (B, S, H, D) views
])
def test_sm90_kernel_within_derived_bound(card, rng, b, hq, hkv, sq, sk, causal, layout):
    """bf16 at D = 128 across several ring stages and diagonal tiles: within
    :func:`_within_bf16_bound` and within the reference's 3e-2 of the bf16
    plain version."""
    from repro_torch.kernels.flash_attention import attention, attention_plain

    def one(h, s):
        shape = (b, s, h, 128) if layout == "bsh" else (b, h, s, 128)
        t = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(card, torch.bfloat16)
        return t.transpose(1, 2) if layout == "bsh" else t

    q, k, v = one(hq, sq), one(hkv, sk), one(hkv, sk)
    n0 = _launches()
    got = attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _launches() == (n0[0] + 1, n0[1])
    assert got.is_contiguous() and got.shape == (b, hq, sq, 128)
    ok, share = _within_bf16_bound(got, q, k, v, causal)
    assert ok, share
    plain = attention_plain(q, k, v, causal=causal).float()
    assert float((got.float() - plain).abs().max()) < 3e-2


def test_sm90_rows_without_keys_follow_tpu_schedule(card, rng):
    """Sq = 200 > Sk = 128, causal: rows 0-71 see no key. The TPU kernel's
    first front-padded 128-row block (real rows -56..71) skips its only key
    tile and writes 0 there (``tests/test_torch_flash_attention.py::
    test_tpu_kernel_zeroes_rows_of_skipped_blocks``); the sm90 kernel lays
    its query tiles out the same way, so those rows are exactly 0, and the
    others lie within :func:`_within_bf16_bound`."""
    from repro_torch.kernels.flash_attention import attention

    q, k, v = (torch.from_numpy(rng.normal(0, 1, (1, 2, s, 64)).astype(np.float32))
               .to(card, torch.bfloat16) for s in (200, 128, 128))
    got = attention(q, k, v, causal=True)
    assert bool((got[:, :, :72] == 0).all())
    ok, share = _within_bf16_bound(got[:, :, 72:], q[:, :, 72:], k, v, True)
    assert ok, share


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", [(1, 2, 2, 200, 128, 64), (1, 4, 2, 300, 128, 128)])
def test_f32_rows_without_keys_follow_tpu_schedule(card, rng, b, hq, hkv, sq, sk, d):
    """float32, causal, Sq > Sk: rows r < Sq - Sk see no key. The float32
    kernel lays out its 128-row query tiles as the reference's front-padded
    blocks, so those rows lie in tiles it skips whole and are exactly 0, as
    through the TPU kernel (``tests/test_torch_flash_attention.py::
    test_split_tf32_rows_without_keys_match_tpu_kernel``); the others lie
    within the reference's 2e-5 of the plain version."""
    from repro_torch.kernels.flash_attention import attention, attention_plain

    q, k, v = (torch.from_numpy(rng.normal(0, 1, (b, h, s, d)).astype(np.float32)).to(card)
               for h, s in ((hq, sq), (hkv, sk), (hkv, sk)))
    torch.backends.cuda.matmul.allow_tf32 = False
    n0 = _launches()
    got = attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert _launches() == (n0[0], n0[1] + 1)
    dark = sq - sk
    assert bool((got[:, :, :dark] == 0).all())
    want = attention_plain(q, k, v, causal=True)
    assert float((got[:, :, dark:] - want[:, :, dark:]).abs().max()) < 2e-5


@pytest.mark.parametrize("b,hq,hkv,sq,sk,causal,layout", [
    (1, 2, 2, 1024, 1024, True, "bhsd"),    # sixteen key tiles, eight query tiles
    (1, 2, 2, 2048, 2048, True, "bhsd"),    # thirty-two key tiles
    (1, 32, 8, 1024, 1024, True, "bsh"),    # qwen3-8b's GQA 32/8, as the model passes views
    (1, 2, 2, 1000, 1024, True, "bhsd"),    # ragged q: the first query tile starts at -24
    (1, 2, 2, 1024, 1024, False, "bhsd"),   # non-causal: no diagonal tile
    (1, 4, 2, 256, 256, True, "odd"),       # rows 129 floats apart: the 4-byte copies
])
def test_f32_kernel_multi_tile(card, rng, b, hq, hkv, sq, sk, causal, layout):
    """float32 at D = 128 across many double-buffered K/V tiles and the
    diagonal, V rows all distinct (the P.V fragment reads V's rows in a
    permuted order): within the reference's 2e-5 of the plain version."""
    from repro_torch.kernels.flash_attention import attention, attention_plain

    def one(h, s):
        shape = (b, s, h, 128) if layout == "bsh" else (b, h, s, 128 + (layout == "odd"))
        t = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(card)
        return t.transpose(1, 2) if layout == "bsh" else t[..., :128]

    q, k, v = one(hq, sq), one(hkv, sk), one(hkv, sk)
    torch.backends.cuda.matmul.allow_tf32 = False
    n0 = _launches()
    got = attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _launches() == (n0[0], n0[1] + 1)
    assert got.is_contiguous() and got.shape == (b, hq, sq, 128)
    want = attention_plain(q, k, v, causal=causal)
    assert float((got - want).abs().max()) < 2e-5


def test_flash_routes_by_dtype(card, rng):
    """bf16 launches the sm90 kernel and float32 the split-TF32 kernel, each
    counted by its own wrapper; each wrapper refuses the other's dtype."""
    from repro_torch.kernels.flash_attention import kernel

    q = torch.from_numpy(rng.normal(0, 1, (1, 2, 128, 64)).astype(np.float32)).to(card)
    n0 = _launches()
    kernel.flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16())
    assert _launches() == (n0[0] + 1, n0[1])
    kernel.flash_attention(q, q, q)
    assert _launches() == (n0[0] + 1, n0[1] + 1)
    with pytest.raises(TypeError):
        kernel.flash_attention_sm90(q, q, q)
    with pytest.raises(TypeError):
        kernel.flash_attention_f32(q.bfloat16(), q.bfloat16(), q.bfloat16())


def test_flash_kernel_takes_strided_views(card, rng):
    """(B, S, H, D) tensors go in as transposed views, as the model passes them."""
    from repro_torch.kernels.flash_attention import attention, attention_plain

    q, k, v = (torch.from_numpy(rng.normal(0, 1, (2, 256, h, 64)).astype(np.float32))
               .to(card).transpose(1, 2) for h in (8, 2, 2))
    got = attention(q, k, v)
    want = attention_plain(q.contiguous(), k.contiguous(), v.contiguous())
    assert float((got - want).abs().max()) < 2e-5


def test_flash_kernel_rejects_unsupported_head_dim(card):
    from repro_torch.kernels.flash_attention import kernel

    q = torch.zeros((1, 2, 128, 96), device=card)
    with pytest.raises(ValueError, match="head dim"):
        kernel.flash_attention(q, q, q)


def test_lm_forward_on_card_launches_flash(card):
    """A reduced dense model on the card: one flash launch per layer, and
    logits close to the same model's plain attention."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    base = dataclasses.replace(get_config("qwen3-8b").reduced(), n_kv_heads=2)
    toks = np.random.default_rng(3).integers(0, base.vocab, (2, 256)).astype(np.int32)
    params = build_model(base).init(0, device=card)
    n0 = kernel.flash_attention_f32.launches    # the reduced config computes in float32
    flash, _, _ = build_model(dataclasses.replace(base, attn_impl="flash")).forward(
        params, {"tokens": toks})
    torch.cuda.synchronize()
    assert kernel.flash_attention_f32.launches == n0 + base.n_layers
    plain, _, _ = build_model(dataclasses.replace(base, attn_impl="ref")).forward(
        params, {"tokens": toks})
    rel = float((flash - plain).abs().max() / plain.abs().max())
    assert rel < 1e-4, rel


@pytest.mark.parametrize("arch", ["minicpm3-4b", "qwen2-moe-a2.7b", "arctic-480b", "mamba2-130m",
                                  "zamba2-1.2b", "whisper-medium", "pixtral-12b", "spatial-lm"])
def test_family_forward_on_card_matches_cpu(card, arch):
    """Each family's reduced config (float32, ``attn_impl="flash"``) on the
    card: one float32 flash launch per attention call (whisper's encoder
    non-causal), and logits, loss and a prefill + decode within 1e-4
    relative of the same model on the CPU (float32 sum order; TF32 off)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.models import build_model, flash_calls, params_to

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch).reduced(), attn_impl="flash")
    rng = np.random.default_rng(5)
    n_tok = 256 - cfg.vision_tokens if cfg.family == "vlm" else 256
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, n_tok)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(0, 1, (2, 128, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(0, 1, (2, cfg.vision_tokens, cfg.frontend_dim)).astype(
            np.float32)
    model = build_model(cfg)
    cpu = model.init(0, device="cpu")
    gpu = params_to(cpu, card)
    n0 = kernel.flash_attention_f32.launches
    got, _, _ = model.forward(gpu, batch)
    torch.cuda.synchronize()
    assert kernel.flash_attention_f32.launches == n0 + flash_calls(cfg)
    want, _, _ = model.forward(cpu, batch)
    rel = float((got.cpu() - want).abs().max() / want.abs().max())
    assert rel < 1e-4, rel
    lg, _ = model.loss(gpu, batch)
    lc, _ = model.loss(cpu, batch)
    assert abs(float(lg) - float(lc)) <= 1e-4 * abs(float(lc))
    # prefill S - 1 positions, an SSM's in whole chunks and then the rest
    toks = batch["tokens"]
    cut = toks.shape[1] - 1
    if cfg.ssm is not None:
        cut = cut // cfg.ssm.chunk * cfg.ssm.chunk
    outs = []
    for params, dev in ((gpu, card), (cpu, "cpu")):
        cache = model.init_cache(2, 384, device=dev)
        _, cache = model.forward_with_cache(params, dict(batch, tokens=toks[:, :cut]), cache)
        _, cache = model.forward_with_cache(params, {"tokens": toks[:, cut:-1]}, cache)
        step, _ = model.decode_step(params, toks[:, -1:], cache)
        outs.append(step.cpu())
    rel = float((outs[0] - outs[1]).abs().max() / outs[1].abs().max())
    assert rel < 1e-4, rel


def test_moe_block_on_card_is_deterministic(card):
    """The combine sums each token's k contributions in (token, k) order, no
    atomics: two runs on the card give the same bits, in bf16 too."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.moe import moe_block

    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b").reduced(), dtype="bfloat16")
    p = build_model(cfg).init(0, device=card)["layers"]["moe"]
    lp = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict) else v[0])
          for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(6).normal(0, 1, (2, 512, cfg.d_model))
                         .astype(np.float32)).to(card, torch.bfloat16)
    a, _ = moe_block(cfg, lp, x)
    b, _ = moe_block(cfg, lp, x)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_spatial_lm_server_on_card_matches_cpu(card):
    """spatial-lm at the tokenizer's vocab (reduced widths, float32) serves
    the same greedy tokens on the card as on the CPU."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import PORTO_BBOX, porto_taxi_like
    from repro_torch.data.tokenizer import GeoTokenizer
    from repro_torch.models import build_model, params_to
    from repro_torch.serve import BatchedServer

    torch.backends.cuda.matmul.allow_tf32 = False
    tok = GeoTokenizer(PORTO_BBOX, order=6)
    cfg = dataclasses.replace(get_config("spatial-lm").reduced(), vocab=tok.vocab)
    cpu = build_model(cfg).init(0, device="cpu")
    gpu = params_to(cpu, card)
    mat = tok.encode_trajectories(porto_taxi_like(8, seed=9), 64)
    out = []
    for params in (gpu, cpu):
        srv = BatchedServer(cfg, params, max_batch=4, max_len=64)
        for i in range(8):
            srv.submit(mat[i][mat[i] > 0][:16], max_new_tokens=12, rid=i)
        out.append({r.rid: r.out_tokens for r in srv.run()})
    assert out[0] == out[1]


def _flat_tree(tree):
    """``{path: leaf}`` of a nested dict, in the port's one leaf order."""
    return dict(flatten_with_paths(tree))


@pytest.mark.parametrize("arch", ["spatial-lm", "internlm2-1.8b"])
def test_train_step_on_card_matches_cpu(card, arch):
    """One reduced train step (AdamW, grad accumulation over 2 microbatches)
    on the card against the same step on the CPU: gradients within 1e-4 of
    each leaf's largest magnitude (float32 sum order; TF32 off), the loss
    within 1e-5, both moments within 1e-4 of their leaf's largest magnitude,
    and each parameter within what the two sides' moments imply (Adam's
    ratio g / (|g| + eps) is steep near a zero gradient)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, params_to
    from repro_torch.train.optimizer import OptConfig, opt_init
    from repro_torch.train.train_loop import make_train_step, value_and_grad

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch).reduced(), grad_accum=2)
    oc = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 2, 64)).astype(np.int32)
    cpu = build_model(cfg).init(0, device="cpu")
    gpu = params_to(cpu, card)
    grad_fn = value_and_grad(build_model(cfg).loss)
    (lg, _), gg = grad_fn(gpu, {"tokens": toks[0]})
    (lc, _), gc = grad_fn(cpu, {"tokens": toks[0]})
    assert abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc))
    gg, gc = _flat_tree(gg), _flat_tree(gc)
    for k in gc:
        assert gg[k].device.type == "cuda"
        assert float((gg[k].cpu() - gc[k]).abs().max()) <= 1e-4 * float(gc[k].abs().max()), k
    out = {}
    for name, params in (("gpu", gpu), ("cpu", cpu)):
        step, _ = make_train_step(cfg, oc, 4, 64, device=params["embed"].device)
        state = opt_init(oc, params)
        p, s, m = step(params, state, {"tokens": toks})
        out[name] = (_flat_tree(p), _flat_tree(s["m"]), _flat_tree(s["v"]), float(m["loss"]))
    (pg, mg, vg, lossg), (pc, mc, vc, lossc) = out["gpu"], out["cpu"]
    assert abs(lossg - lossc) <= 1e-5 * abs(lossc)

    def ratio(m, v):
        m, v = m.double(), v.double()
        return (m / (1 - oc.b1)) / (torch.sqrt(v / (1 - oc.b2)) + oc.eps)

    for k in pc:
        for a, b in ((mg[k], mc[k]), (vg[k], vc[k])):
            assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(b.abs().max()), k
        dr = (ratio(mg[k].cpu(), vg[k].cpu()) - ratio(mc[k], vc[k])).abs()
        bound = oc.lr * (dr + 1e-4) + 2.0 ** -22 * pc[k].double().abs()
        assert bool(((pg[k].cpu().double() - pc[k].double()).abs() <= bound).all()), k


def test_flash_raises_under_grad_on_card(card):
    """A backward through ``attn_impl="flash"`` raises on the card, before
    any launch, as on the CPU; without a gradient the kernel runs."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel, ops
    from repro_torch.models import build_model
    from repro_torch.train.train_loop import value_and_grad

    cfg = dataclasses.replace(get_config("qwen3-8b").reduced(), attn_impl="flash")
    model = build_model(cfg)
    params = model.init(0, device=card)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 128)).astype(np.int32)
    n0 = kernel.flash_attention_f32.launches
    with pytest.raises(RuntimeError, match="no backward"):
        value_and_grad(model.loss)(params, {"tokens": toks})
    q = torch.randn(1, 2, 128, 32, device=card, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.attention(q, q.detach(), q.detach())
    assert kernel.flash_attention_f32.launches == n0
    model.loss(params, {"tokens": toks})
    torch.cuda.synchronize()
    assert kernel.flash_attention_f32.launches == n0 + cfg.n_layers


def test_checkpoint_from_card_restores_bit_equal(card, tmp_path):
    """A checkpoint written from card tensors (float32, bf16, float8, int32
    and the step scalar, compressed and raw leaves) restores on the card
    bit for bit."""
    from repro_torch.train.checkpoint import CheckpointManager

    g = torch.Generator(device=card)
    g.manual_seed(0)
    params = {"w": torch.randn(64, 48, device=card, generator=g),
              "bf": torch.randn(33, 67, device=card, generator=g).to(torch.bfloat16),
              "f8": torch.randn(2000, device=card, generator=g).to(torch.float8_e4m3fn),
              "small": torch.randn(7, device=card, generator=g),
              "ids": torch.randint(0, 9, (4, 512), device=card, dtype=torch.int32,
                                   generator=g)}
    opt = {"m": {"w": torch.randn(64, 48, device=card, generator=g)},
           "step": torch.tensor(17, dtype=torch.int32, device=card)}
    want = {k: v.clone() for k, v in _flat_tree({"params": params, "opt_state": opt}).items()}
    mgr = CheckpointManager(tmp_path, compress=True, async_save=True)
    mgr.save(17, params, opt)
    params["w"].add_(1.0)          # the snapshot is taken before save returns
    mgr.wait()
    step, p2, o2 = CheckpointManager(tmp_path).restore_latest(device=card)
    assert step == 17
    got = _flat_tree({"params": p2, "opt_state": o2})
    assert set(got) == set(want)
    iv = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
    for k in want:
        assert got[k].device.type == "cuda" and got[k].dtype == want[k].dtype, k
        a, b = got[k].view(iv[got[k].element_size()]), want[k].view(iv[want[k].element_size()])
        assert torch.equal(a, b), k
