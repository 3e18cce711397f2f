"""Card-only tests: each CUDA kernel against its plain PyTorch version.

These import only the port (no JAX), so they run on a machine with a card
and no JAX: ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Each test decides inside itself whether a card exists and skips without
one. Inputs are made with numpy from a seed; tolerance: exact bit patterns.
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
