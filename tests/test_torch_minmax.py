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


# ---------------------------------------------- kernel 3's blocks, emulated
_THREADS = 256


def _okey(b: np.ndarray) -> np.ndarray:
    """Kernel 3's int32 order key of uint32 patterns: the magnitude bits
    flipped when the sign is set, so two's complement order is the total
    order of non-NaN floats (-0 below +0). The map is its own inverse."""
    b = np.asarray(b, np.uint32)
    return (b ^ np.where(b >> 31 != 0, np.uint32(0x7FFFFFFF), np.uint32(0))).view(np.int32)


def _block_page_minmax(bits: np.ndarray, bounds: np.ndarray):
    """Kernel 3's algorithm on uint32 patterns: one block of 256 threads a
    page, thread t reducing values bounds[p] + t, + 256, ... (denormals as
    signed zeros, NaN patterns by unsigned max, the rest by int32 order key
    from the keys of +inf and -inf), then a butterfly of xor shuffles in
    each warp, then thread 0 folding the eight warp results; a NaN wins,
    and the keys map back through the same map."""
    init = _okey(np.array([0x7F800000, 0xFF800000], np.uint32))
    mn = np.empty(len(bounds) - 1, np.uint32)
    mx = np.empty(len(bounds) - 1, np.uint32)
    for p in range(len(bounds) - 1):
        b = np.asarray(bits[bounds[p]:bounds[p + 1]], np.uint32)
        b = np.where((b & 0x7F800000) == 0, b & np.uint32(0x80000000), b)
        nan = (b & 0x7FFFFFFF) > 0x7F800000
        pad = -len(b) % _THREADS
        # one row per stride of the block: column t holds thread t's values
        k = np.concatenate([_okey(b), np.zeros(pad, np.int32)]).reshape(-1, _THREADS)
        live = np.concatenate([~nan, np.zeros(pad, bool)]).reshape(-1, _THREADS)
        isnan = np.concatenate([nan, np.zeros(pad, bool)]).reshape(-1, _THREADS)
        u = np.concatenate([b, np.zeros(pad, np.uint32)]).reshape(-1, _THREADS)
        kmn = np.where(live, k, init[0]).min(axis=0, initial=init[0]).reshape(8, 32)
        kmx = np.where(live, k, init[1]).max(axis=0, initial=init[1]).reshape(8, 32)
        knan = np.where(isnan, u, 0).max(axis=0, initial=0).reshape(8, 32)
        for d in (16, 8, 4, 2, 1):
            other = np.arange(32) ^ d
            kmn, kmx, knan = (np.minimum(kmn, kmn[:, other]), np.maximum(kmx, kmx[:, other]),
                              np.maximum(knan, knan[:, other]))
        f_mn, f_mx, f_nan = kmn[0, 0], kmx[0, 0], knan[0, 0]
        for w in range(1, 8):
            f_mn, f_mx, f_nan = min(f_mn, kmn[w, 0]), max(f_mx, kmx[w, 0]), max(f_nan, knan[w, 0])
        mn[p] = f_nan if f_nan else _okey(np.array([f_mn], np.int32).view(np.uint32))[0]
        mx[p] = f_nan if f_nan else _okey(np.array([f_mx], np.int32).view(np.uint32))[0]
    return mn.view(np.float32), mx.view(np.float32)


def _page_case(rng, case):
    """(values, bounds) for one case of kernel 3."""
    def normal(n, loc=0.0):
        return rng.normal(loc, 1e3, n).astype(np.float32)

    if case == "small_pages":
        sizes = rng.integers(1, 60, 400)
    elif case == "pages_of_many_strides":
        sizes = rng.integers(4000, 20000, 6)
    elif case == "empty_runs":
        sizes = np.zeros(1200, np.int64)
        real = rng.choice(1200, 40, replace=False)
        sizes[real] = rng.integers(1, 3000, 40)
    elif case == "page_131072":
        sizes = np.array([5, 131_072, 0, 4099])
    elif case in ("signed_zeros", "denormals", "nan_pages"):
        sizes = np.array([3, 4096, 5000, 1, 0, 9000, 17])
    else:
        raise ValueError(case)
    v = normal(int(sizes.sum()), loc=-7.0)
    bounds = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    tiny = np.finfo(np.float32).smallest_subnormal
    if case == "signed_zeros":
        # -0 and +0 in both orders, a page's two zeros on different threads
        v[:] = np.abs(v)
        for p, order in ((1, (-0.0, 0.0)), (2, (0.0, -0.0)), (5, (-0.0, 0.0))):
            a, b = bounds[p], bounds[p + 1]
            v[a + 2], v[b - 1] = order
        v[bounds[3]] = -0.0
    elif case == "denormals":
        v[:] = np.abs(v)
        v[bounds[1]:bounds[2]] = tiny * rng.integers(1, 100, 4096)
        v[bounds[2] + 3000] = -tiny
        v[bounds[5]:bounds[6]] = -np.abs(v[bounds[5]:bounds[6]])
        v[bounds[5] + 8000] = -tiny * 3
    elif case == "nan_pages":
        pool = np.array([0x7FC00000, 0x7FC00001, 0xFFC00005, 0x7F800001, 0xFFFFFFFF],
                        np.uint32).view(np.float32)
        v[bounds[1] + 10] = pool[0]
        v[bounds[1] + 4000] = pool[1]                   # the larger pattern, another warp
        v[bounds[2]:bounds[3]] = pool[rng.integers(0, 5, 5000)]   # all NaN
        v[bounds[5] + 8999] = pool[4]
        v[bounds[6]:bounds[7]] = np.inf
    return v, bounds


def _outside(n):
    """Values outside every page, which no page may see."""
    return np.full(n, -1e30, np.float32)


PAGE_CASES = ["small_pages", "pages_of_many_strides", "empty_runs", "page_131072",
              "signed_zeros", "denormals", "nan_pages"]


@pytest.mark.parametrize("start", [0, 5, 4093])
@pytest.mark.parametrize("case", PAGE_CASES)
def test_block_page_minmax_equals_plain(rng, case, start):
    """Kernel 3's one block a page, emulated, on every case, with the first
    page starting ``start`` values in (off a 16-byte boundary for 5 and
    4093): equal to ``page_minmax_ref`` bit for bit, and on every page
    without NaN to the JAX reference's ``column_page_stats_ex``."""
    v, bounds = _page_case(rng, case)
    v = np.concatenate([_outside(start), v, _outside(3)])
    bounds = bounds + start
    got = _block_page_minmax(v.view(np.uint32), bounds)
    want = tref.page_minmax_ref(torch.from_numpy(v), torch.from_numpy(bounds))
    for g, w in zip(got, want):
        assert np.array_equal(g.view(np.int32), w.numpy().view(np.int32))
    jmn, jmx, nnan = jmm.column_page_stats_ex(v, bounds, use_pallas=False)
    clean = nnan == 0
    assert np.array_equal(_bits(got[0][clean].astype(np.float64)), _bits(jmn[clean]))
    assert np.array_equal(_bits(got[1][clean].astype(np.float64)), _bits(jmx[clean]))
    tmn, tmx, tnan = tmm.column_page_stats_ex(v, bounds, device="cpu")
    for a, b in zip((jmn, jmx, nnan), (tmn, tmx, tnan)):
        assert np.array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("kind", ["normals", "denormals", "zeros_and_infs", "any_pattern"])
def test_order_key_is_its_own_inverse_in_total_order(rng, kind):
    """The key map inverts itself, and on non-NaN patterns the int32 order
    of keys is the float order with -0 below +0 (what lets the kernel map
    its reduced keys straight back to floats)."""
    if kind == "normals":
        b = rng.normal(0, 1e6, 4000).astype(np.float32).view(np.uint32)
    elif kind == "denormals":
        b = rng.integers(1, 0x800000, 4000, dtype=np.uint32) | (
            rng.integers(0, 2, 4000, dtype=np.uint32) << np.uint32(31))
    elif kind == "zeros_and_infs":
        b = np.array([0, 0x80000000, 0x7F800000, 0xFF800000, 0x00000001, 0x80000001,
                      0x7F7FFFFF, 0xFF7FFFFF], np.uint32)
    else:
        b = rng.integers(0, 2 ** 32, 20000, dtype=np.uint32)
    assert np.array_equal(_okey(_okey(b).view(np.uint32)).view(np.uint32), b)
    b = b[(b & 0x7FFFFFFF) <= 0x7F800000]
    f = b.view(np.float32).astype(np.float64)
    by_key = b[np.argsort(_okey(b), kind="stable")]
    fk = by_key.view(np.float32).astype(np.float64)
    assert np.all(np.diff(fk) >= 0)
    assert sorted(f.tolist()) == fk.tolist()
    zeros = by_key[fk == 0]
    assert np.all(np.diff((zeros >> 31 == 0).astype(np.int8)) >= 0)   # every -0 before +0
