"""The port's page-stream decode module held against the JAX package's.

Pages are made with numpy from a seed and encoded once by the reference's
host codec; both packages build their operands from the same plans and
decode them. JAX runs its Pallas kernel in interpret mode and its flat jnp
oracle; the port runs its plain version on CPU tensors. Tolerance: exact
bit patterns. The CUDA kernel is held against this plain version in
``tests/test_torch_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core.fp_delta import fp_delta_encode, fp_delta_plan  # noqa: E402
from repro.core.pages import PageMeta as JPageMeta  # noqa: E402
from repro.core.pages import page_stream_plan as j_page_stream_plan  # noqa: E402
from repro.core.reader import _bbox_keep_mask  # noqa: E402
from repro.kernels import fp_delta as jfd  # noqa: E402
from repro_torch.core import fp_delta as tcodec  # noqa: E402
from repro_torch.core.pages import PageMeta as TPageMeta  # noqa: E402
from repro_torch.core.pages import page_stream_plan as t_page_stream_plan  # noqa: E402
from repro_torch.kernels import fp_delta as tfd  # noqa: E402
from repro_torch.kernels.fp_delta import ops as tops  # noqa: E402

STREAM_BLOCK = tfd.STREAM_BLOCK


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int64 if a.dtype.itemsize == 8 else np.int32)


def _page(rng, n, density, dtype):
    """One page of ``n`` values with the requested escape density and, for
    "specials", NaN/±inf/±0/denormal values."""
    x = (np.cumsum(rng.normal(0, 1e-4, n)) + 40.7).astype(dtype)
    if density == "none":
        return x
    if density == "sparse":
        hits = rng.integers(0, n, max(n // 500, 2))
        x[hits] = rng.normal(0, 1e30, len(hits)).astype(dtype)
        return x
    if density == "specials":
        pool = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0,
                         np.finfo(dtype).smallest_subnormal,
                         -np.finfo(dtype).smallest_subnormal], dtype)
        x[rng.integers(0, n, max(n // 20, 3))] = pool[rng.integers(0, len(pool), max(n // 20, 3))]
        return x
    # "dense": wild bit patterns force an escape on nearly every delta
    uint = np.uint32 if np.dtype(dtype).itemsize == 4 else np.uint64
    return rng.integers(0, np.iinfo(uint).max, n, dtype=uint, endpoint=True).view(dtype)


def _plans(pages, raw_every=0):
    """Reference plans for ``pages`` (every ``raw_every``-th page stored raw)
    and the port's plans for the same stored bytes."""
    jp, tp = [], []
    for i, p in enumerate(pages):
        if raw_every and i % raw_every == raw_every - 1:
            m = dict(offset=0, nbytes=p.nbytes, count=len(p), rec_start=0,
                     rec_count=0, vmin=0.0, vmax=0.0, encoding="raw",
                     n_bits=0, n_resets=0)
            jp.append(j_page_stream_plan(p.tobytes(), JPageMeta(**m), p.dtype, "none"))
            tp.append(t_page_stream_plan(p.tobytes(), TPageMeta(**m), p.dtype, "none"))
        else:
            payload, _ = fp_delta_encode(p)
            jp.append(fp_delta_plan(payload, len(p), p.dtype))
            tp.append(tcodec.fp_delta_plan(payload, len(p), p.dtype))
    return jp, tp


def _same_arrays(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("density", ["none", "sparse", "dense", "specials"])
@pytest.mark.parametrize("n", [1, STREAM_BLOCK - 1, STREAM_BLOCK + 1, 3000])
def test_decode_matches_jax(rng, dtype, density, n):
    """Builders give identical operands; the port's decode gives the
    reference's limbs (the jnp oracle) and the host decode's bits."""
    pages = [_page(rng, n, density, dtype), _page(rng, max(n // 3, 1), density, dtype)]
    jp, tp = _plans(pages, raw_every=2 if density == "sparse" else 0)
    js, ts = jfd.build_page_stream(jp), tfd.build_page_stream(tp)
    _same_arrays(js, ts)
    lo, hi = (np.asarray(a) for a in jfd.decode_stream_device(js, use_pallas=False))
    bits = tfd.decode_stream_device(ts, device="cpu").numpy()
    if ts.width == 64:
        want = (hi.astype(np.uint64) << 32 | lo.astype(np.uint64)).view(np.int64)
    else:
        want = lo.view(np.int32)
    assert np.array_equal(bits, want)
    got = np.split(tfd.decode_page_stream(ts, device="cpu"), np.cumsum(ts.counts)[:-1])
    for p, g in zip(pages, got):
        assert np.array_equal(_bits(p), _bits(g))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_decode_matches_pallas_kernel(rng, dtype):
    """Against the Pallas kernel itself (interpret mode): escapes, raw pages
    and specials in one multi-block stream."""
    pages = [_page(rng, 1500, d, dtype) for d in ("none", "sparse", "dense", "specials")]
    jp, tp = _plans(pages, raw_every=3)
    js, ts = jfd.build_page_stream(jp), tfd.build_page_stream(tp)
    want = jfd.decode_page_stream(js, use_pallas=True, interpret=True)
    got = tfd.decode_page_stream(ts, device="cpu")
    assert np.array_equal(_bits(want), _bits(got))


def test_decode_pages_chunking_and_host_fallback(rng, monkeypatch):
    """A small launch cap splits pages across launches and host-decodes an
    oversized page: the same bits either way."""
    pages = [_page(rng, int(n), "sparse", np.float64) for n in (700, 40, 2500, 3)]
    _, tp = _plans(pages)
    monkeypatch.setattr(tops, "_MAX_LAUNCH_BITS", 64 * 300)
    out = tfd.decode_pages(tp, device="cpu")
    for p, o in zip(pages, out):
        assert np.array_equal(_bits(p), _bits(o))
    with pytest.raises(ValueError, match="per-launch cap"):
        tfd.build_page_stream(tp)


def _refine_case(rng, dtype, n_rec=70):
    counts = rng.integers(0, 35, n_rec)
    counts[[2, n_rec - 1]] = 0
    total = int(counts.sum())
    x = rng.normal(0, 5, total).astype(dtype)
    y = rng.normal(0, 5, total).astype(dtype)
    pool = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 5e-324], dtype)
    x[rng.integers(0, total, 20)] = pool[rng.integers(0, len(pool), 20)]
    split = 31
    vs = int(counts[:split].sum())
    pages = [x[:vs], y[:vs], x[vs:], y[vs:]]
    jp, tp = _plans(pages)
    pairs = [(0, split), (split, n_rec)]
    js, ts = jfd.build_page_stream(jp), tfd.build_page_stream(tp)
    ja = jfd.build_refine_aux(js, pairs, counts)
    ta = tfd.build_refine_aux(ts, pairs, counts)
    return js, ja, ts, ta, x, y, counts


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_refine_and_gather_match_jax(rng, dtype, use_pallas):
    """Refine aux arrays identical; survivor masks equal the reference's
    fused refine and the host oracle; gathered survivors are bit-exact."""
    js, ja, ts, ta, x, y, counts = _refine_case(rng, dtype)
    _same_arrays(ja, ta)
    for bbox in ((-2.0, -3.0, 4.0, 3.0), (-0.0, -0.0, 0.0, 0.0),
                 (-np.inf, -np.inf, np.inf, np.inf)):
        jr = jfd.decode_refine_stream(js, ja, bbox, use_pallas=use_pallas, interpret=True)
        tr = tfd.decode_refine_stream(ts, ta, bbox, device="cpu")
        assert np.array_equal(jr.keep, tr.keep), bbox
        assert np.array_equal(tr.keep, _bbox_keep_mask(x, y, counts, bbox)), bbox
        sel = tr.keep
        ix = tfd.ragged_ranges(ta.x_start[sel], ta.counts[sel])
        assert np.array_equal(ix, jfd.ragged_ranges(ja.x_start[sel], ja.counts[sel]))
        got = tfd.gather_stream_values(tr.bits, ix, dtype)
        want = jfd.gather_stream_values(jr.lo, jr.hi, ix, np.dtype(dtype).itemsize * 8, dtype)
        assert np.array_equal(_bits(got), _bits(want))
        on_dev = tfd.gather_stream_values(tr.bits, ix, dtype, keep_on_device=True)
        assert np.array_equal(_bits(on_dev.to_numpy()), _bits(want))


def test_nan_bbox_keeps_nothing_without_launch(rng):
    _, _, ts, ta, *_ = _refine_case(rng, np.float64)
    res = tfd.decode_refine_stream(ts, ta, (np.nan, 0.0, 1.0, 1.0), device="cpu")
    assert not res.keep.any() and res.bits.numel() == 0
    empty = tfd.gather_stream_values(res.bits, np.zeros(0, np.int64), np.float64,
                                     keep_on_device=True)
    assert len(empty) == 0 and empty.to_numpy().dtype == np.float64


def test_stream_from_numpy_takes_reference_operands(rng):
    """The reference's numpy operands become the port's tensors unchanged."""
    js, ja, *_ = _refine_case(rng, np.float64)
    ds = tfd.stream_from_numpy(js, ja, device="cpu")
    assert np.array_equal(ds.words32.numpy(), js.words32)
    assert np.array_equal(ds.tok_off.numpy(), js.tok_off)
    assert np.array_equal(ds.nbits.numpy(), js.nbits)
    assert np.array_equal(ds.anchor.numpy(), js.anchor)
    assert np.array_equal(ds.x_start.numpy(), ja.x_start)
    assert np.array_equal(ds.counts.numpy(), ja.counts)
    assert np.array_equal(ds.valid.numpy(), ja.valid[: ja.n_records])
    assert ds.width == 64 and ds.n_values == js.n_values


def test_kernel_wrapper_takes_only_cuda_tensors(rng):
    """The CUDA wrapper never runs the plain version for a CPU tensor: the
    dispatch in ops.py does that, by the tensor's device."""
    from repro_torch.kernels.fp_delta import kernel

    _, _, ts, ta, *_ = _refine_case(rng, np.float64)
    ds = tfd.stream_from_numpy(ts, ta, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.decode_stream(ds.words32, ds.tok_off, ds.nbits, ds.anchor, ds.width)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.expand_stream(torch.from_numpy(ts.page_table), torch.from_numpy(ts.escapes),
                             ts.n_values, ts.width, ts.shape[0])
    assert kernel.decode_stream.launches == 0 and kernel.expand_stream.launches == 0


# ------------------------------------- the decode kernel's cross-tile algebra
def _look_back_stitch(vals, anc, tile, mask):
    """The one-pass kernel's result, tile by tile: each tile's local
    segmented sum, then the carry from a decoupled look-back. A tile with an
    anchor (or tile 0) publishes its inclusive value; any other tile its
    aggregate. Unless its first position is an anchor, a tile then looks
    back 32 predecessors at a time (lane 31 the nearest) to the highest
    inclusive one, adding the aggregates above it: the carry into the
    positions before its first anchor."""
    def wrap(x):  # int64 two's complement, as the kernel's sums mod 2^64
        return (x + 2 ** 63) % 2 ** 64 - 2 ** 63

    n = vals.shape[0]
    n_tiles = -(-n // tile)
    agg, incl = [None] * n_tiles, [None] * n_tiles
    out = torch.empty_like(vals)
    for t in range(n_tiles):
        v, a = vals[t * tile:(t + 1) * tile], anc[t * tile:(t + 1) * tile]
        local = tfd.ref.segmented_sum(v, a)
        seen = torch.cumsum(a.to(torch.int64), 0) > 0
        total = int(local[-1])
        prefix = 0
        if t == 0 or bool(a.any()):
            incl[t] = total
        else:
            agg[t] = total
        if t > 0 and not bool(a[0]):
            end = t - 1
            while True:
                window = list(range(end - 31, end + 1))
                hits = [i for i, j in enumerate(window) if j >= 0 and incl[j] is not None]
                lo = hits[-1] if hits else 0
                for j in window[lo:]:
                    if j >= 0:
                        prefix = wrap(prefix + (incl[j] if incl[j] is not None else agg[j]))
                if hits:
                    break
                end -= 32
            if incl[t] is None:
                incl[t] = wrap(prefix + total)
        out[t * tile:(t + 1) * tile] = torch.where(seen, local, local + prefix)
    return out & mask


@pytest.mark.parametrize("width", [32, 64])
@pytest.mark.parametrize("anchors", ["inside_tiles", "none_over_many_tiles", "all"])
@pytest.mark.parametrize("tile", [1024, 2048, 4096])
def test_tile_stitching_equals_segmented_sum(rng, tile, anchors, width):
    """``segmented_sum`` over a stream equals tile-local segmented sums
    stitched by the look-back's exclusive segmented prefix of the tile
    aggregates, in W-bit arithmetic (mod 2^32 commutes with the sums), over
    70 tiles and a half tile (three look-back windows, a partial last tile)."""
    n = 70 * tile + tile // 2
    vals = torch.from_numpy(rng.integers(-(2 ** 62), 2 ** 62, n, dtype=np.int64))
    if anchors == "inside_tiles":
        anc = torch.from_numpy(rng.random(n) < 1.5 / tile)
        anc[5 * tile:40 * tile] = False          # and a run of 35 anchor-free tiles
    elif anchors == "none_over_many_tiles":
        anc = torch.zeros(n, dtype=torch.bool)   # values before any anchor sum from 0
        anc[3] = True
    else:
        anc = torch.ones(n, dtype=torch.bool)
    mask = (1 << 32) - 1 if width == 32 else -1
    want = tfd.ref.segmented_sum(vals, anc) & mask
    assert torch.equal(_look_back_stitch(vals, anc, tile, mask), want)
