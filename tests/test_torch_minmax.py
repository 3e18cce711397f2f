"""The port's min/max module held against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages. JAX runs
as its own tests run it on the CPU: the Pallas kernels in interpret mode
(``use_pallas=True``) and the jnp oracles (``use_pallas=False``). The port
runs its plain versions on CPU tensors. Tolerance: exact bit patterns.
The CUDA kernels are held against these plain versions in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import fp_delta as jfd  # noqa: E402
from repro.kernels import minmax as jmm  # noqa: E402
from repro.core.fp_delta import fp_delta_encode, fp_delta_plan  # noqa: E402
from repro_torch.kernels import fp_delta as tfd  # noqa: E402
from repro_torch.kernels import minmax as tmm  # noqa: E402
from repro_torch.kernels.minmax import ref as tref  # noqa: E402

_TINY32 = np.finfo(np.float32).smallest_subnormal


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int64 if a.dtype.itemsize == 8 else np.int32)


def _pages_f32(rng):
    """Ragged float32 pages: ±0 in both orders, one-NaN-pattern pages,
    all-NaN pages, empty pages, infinities and denormals."""
    pages = [
        np.array([0.0, -0.0], np.float32),
        np.array([-0.0, 0.0, 0.0], np.float32),
        np.array([1.0, np.nan, -3.0, np.nan], np.float32),
        np.full(5, np.nan, np.float32),
        np.zeros(0, np.float32),
        np.array([np.inf, -np.inf, _TINY32, -_TINY32], np.float32),
        np.array([-np.nan, 2.0], np.float32),
        np.array([-_TINY32, -0.0], np.float32),
        rng.normal(0, 1e3, 3000).astype(np.float32),
        rng.normal(-5, 1, 2049).astype(np.float32),
    ]
    values = np.concatenate(pages)
    bounds = np.concatenate([[0], np.cumsum([len(p) for p in pages])]).astype(np.int64)
    return values, bounds


def test_page_stats_match_jax(rng):
    """Per-page min/max through both packages' ragged entry: the Pallas
    kernel (interpret) and the port's plain version give the same bits on
    every page, NaN pages included (each holds one NaN pattern)."""
    values, bounds = _pages_f32(rng)
    jmn, jmx = jmm.column_page_stats(values, bounds, use_pallas=True, interpret=True)
    tmn, tmx = tmm.column_page_stats(values, bounds, device="cpu")
    assert np.array_equal(_bits(jmn), _bits(tmn))
    assert np.array_equal(_bits(jmx), _bits(tmx))
    # the signed-zero rule: -0.0 below +0.0 whatever the order
    assert _bits(tmn[:2]).tolist() == _bits(np.array([-0.0, -0.0])).tolist()
    assert _bits(tmx[:2]).tolist() == _bits(np.array([0.0, 0.0])).tolist()


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64])
def test_column_page_stats_ex_match_jax(rng, dtype):
    values, bounds = _pages_f32(rng)
    if np.dtype(dtype).kind == "i":
        values = rng.integers(-(1 << 62), 1 << 62, len(values), dtype=np.int64)
    else:
        values = values.astype(dtype)
    want = jmm.column_page_stats_ex(values, bounds, use_pallas=False)
    got = tmm.column_page_stats_ex(values, bounds, device="cpu")
    for w, g in zip(want, got):
        assert w.dtype == g.dtype
        assert np.array_equal(_bits(w), _bits(g))


def test_page_minmax_matches_jax_dense(rng):
    """The dense (n_pages, page_size) form of the reference against the
    port's ragged form over the same rows."""
    x = rng.normal(0, 10, (6, 4096)).astype(np.float32)
    x[1, 7] = -0.0
    x[1, 9] = 0.0
    x[2] = np.abs(x[2])
    x[2, 100] = 0.0
    x[2, 5] = -0.0
    x[3, 11] = np.nan
    jmn, jmx = jmm.page_minmax(jnp.asarray(x), use_pallas=False)
    bounds = torch.arange(0, x.size + 1, x.shape[1], dtype=torch.int64)
    tmn, tmx = tmm.page_minmax(torch.from_numpy(x.reshape(-1)), bounds)
    assert np.array_equal(_bits(np.asarray(jmn)), _bits(tmn.numpy()))
    assert np.array_equal(_bits(np.asarray(jmx)), _bits(tmx.numpy()))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bbox_query_keys_match_jax(dtype):
    boxes = [
        (-8.7, 41.1, -8.5, 41.25), (0.0, -0.0, -0.0, 0.0),
        (1e-45, -1e-45, 3.4e38, 1e300), (np.nan, 0.0, 1.0, 1.0),
        (2.0, 0.0, 1.0, 1.0), (-np.inf, -np.inf, np.inf, np.inf),
        (0.1, 0.2, 0.3, 0.4),
    ]
    for b in boxes:
        want = jmm.bbox_query_keys(b, np.dtype(dtype))
        got = tmm.bbox_query_keys(b, np.dtype(dtype))
        assert (want is None) == (got is None), b
        if want is not None:
            assert np.array_equal(want, got), b
    wk, wv = jmm.stack_bbox_query_keys(boxes, np.dtype(dtype))
    gk, gv = tmm.stack_bbox_query_keys(boxes, np.dtype(dtype))
    assert np.array_equal(wk, gk) and np.array_equal(wv, gv)
    assert jmm.inf_keys(32) == tmm.inf_keys(32) and jmm.inf_keys(64) == tmm.inf_keys(64)


@pytest.mark.parametrize("width", [32, 64])
def test_float_order_keys_match_jax(rng, width):
    """The port's signed 64-bit keys are the reference's (lo, hi) limb pair
    with the top bit flipped."""
    itype = np.int32 if width == 32 else np.int64
    ftype = np.float32 if width == 32 else np.float64
    specials = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0,
                         np.finfo(ftype).smallest_subnormal, 1.5, -2.5], ftype)
    raw = rng.integers(np.iinfo(itype).min, np.iinfo(itype).max, 500, dtype=itype)
    bits = np.concatenate([specials.view(itype), raw])
    u = bits.view(np.uint32 if width == 32 else np.uint64)
    if width == 32:
        lo, hi = u, np.zeros_like(u)
    else:
        lo, hi = (u & 0xFFFFFFFF).astype(np.uint32), (u >> 32).astype(np.uint32)
    klo, khi = jmm.float_order_keys(jnp.asarray(lo), jnp.asarray(hi), width)
    want = (np.asarray(khi).astype(np.uint64) << 32) | np.asarray(klo).astype(np.uint64)
    got = tref.unsigned_key_bits(tmm.float_order_keys(torch.from_numpy(bits), width))
    assert np.array_equal(got.numpy().view(np.uint64), want)


def _stream(rng, dtype, n_rec=90, specials=True):
    """Record-aligned x/y pages through the reference's builders, with NaN,
    ±inf, ±0 and denormal coordinates and empty records."""
    counts = rng.integers(0, 30, n_rec)
    counts[3] = 0
    total = int(counts.sum())
    x = rng.normal(0, 5, total).astype(dtype)
    y = rng.normal(0, 5, total).astype(dtype)
    if specials:
        pool = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0,
                         np.finfo(dtype).smallest_subnormal], dtype)
        hit = rng.integers(0, total, 25)
        x[hit] = pool[rng.integers(0, len(pool), 25)]
        y[hit[::2]] = pool[rng.integers(0, len(pool), len(hit[::2]))]
    split = n_rec // 3
    vs = int(counts[:split].sum())
    plans = []
    for lo_, hi_ in ((0, vs), (vs, total)):
        for v in (x[lo_:hi_], y[lo_:hi_]):
            payload, _ = fp_delta_encode(v)
            plans.append(fp_delta_plan(payload, len(v), np.dtype(dtype)))
    stream = jfd.build_page_stream(plans)
    aux = jfd.build_refine_aux(stream, [(0, split), (split, n_rec)], counts)
    return stream, aux, x, y, counts


def _jax_segment_ends(stream, aux, use_pallas):
    """The reference's per-record min/max key limbs at each record's end."""
    lo, hi = jfd.decode_stream_device(stream, use_pallas=False)
    klo, khi = jmm.float_order_keys(lo, hi, stream.width)
    shape = stream.tok_off.shape
    outs = jmm.segment_minmax(
        klo.astype(jnp.int32).reshape(shape), khi.astype(jnp.int32).reshape(shape),
        aux.seg_flag, use_pallas=use_pallas, interpret=True)
    n = aux.n_records
    ends = aux.end_pos[:n]
    res = []
    for e in (ends[:, 0], ends[:, 1]):
        mnlo, mnhi, mxlo, mxhi = (np.asarray(o).astype(np.uint64)[e] for o in outs)
        res += [(mnhi << 32) | mnlo, (mxhi << 32) | mxlo]
    return np.stack(res, 1)  # (R, 4): x_min, x_max, y_min, y_max


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_segminmax_refine_matches_segment_minmax(rng, dtype, use_pallas):
    """Per-record keys at every segment end equal the reference's segmented
    scan (Pallas interpret and jnp oracle); the survivor mask equals the
    reference's fused refine."""
    stream, aux, *_ = _stream(rng, dtype)
    want = _jax_segment_ends(stream, aux, use_pallas)
    bbox = (-3.0, -2.0, 4.0, 6.0)
    ds = tfd.stream_from_numpy(tfd.PageStream(**vars(stream)),
                               tfd.RefineAux(**vars(aux)), device="cpu")
    bits = tfd.decode_stream_bits(ds)
    q = tmm.keys64(tmm.bbox_query_keys(bbox, np.dtype(dtype)))
    keep, mm = tmm.segminmax_refine(bits, ds.x_start, ds.y_start, ds.counts,
                                    ds.valid, q, ds.width)
    got = mm.numpy().view(np.uint64)
    valid = aux.valid[: aux.n_records]
    assert np.array_equal(got[valid], want[valid])
    jres = jfd.decode_refine_stream(stream, aux, bbox, use_pallas=use_pallas,
                                    interpret=True)
    assert np.array_equal(keep.numpy(), jres.keep)


def test_cuda_device_requested_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmm.column_page_stats(np.ones(4, np.float32), np.array([0, 4]))


def test_kernel_wrappers_take_only_cuda_tensors():
    from repro_torch.kernels.minmax import kernel

    v = torch.zeros(8, dtype=torch.float32)
    b = torch.tensor([0, 8])
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.page_minmax(v, b)
    i64 = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.segminmax_refine(i64, i64, i64, i64, torch.ones(2, dtype=torch.bool),
                                (0, 0, 0, 0), 64)
    assert kernel.page_minmax.launches == 0 and kernel.segminmax_refine.launches == 0
