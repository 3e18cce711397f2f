"""The port's miniblock codec held against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages. The
reference encodes with its jnp oracle (``use_pallas=False``) and with its
Pallas kernels in interpret mode (``use_pallas=True``); the port encodes
with its plain version on CPU tensors (``device="cpu"``). Tolerance: exact,
in all six dense arrays, the ``FPD2`` bytes, and the decoded bit patterns.
The CUDA kernels are held against this plain version in
``tests/test_torch_cuda.py``.
"""

import sys
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.kernels import fp_delta as jfd  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fp_delta as tfd  # noqa: E402
from repro_torch.kernels.fp_delta import ref as tref  # noqa: E402

FIELDS = ("packed", "widths", "anchors", "exc_idx", "exc_val", "exc_count")


def _gen(rng, gen, n):
    """The reference's test inputs (tests/test_kernels.py)."""
    if gen == "smooth":
        return (np.cumsum(rng.normal(0, 1e-4, n)) + 41).astype(np.float32)
    if gen == "random":
        return rng.integers(-2**31, 2**31 - 1, n).astype(np.int32).view(np.float32)
    if gen == "constant":
        return np.full(n, 2.5, np.float32)
    x = (np.cumsum(rng.normal(0, 1e-4, n)) + 41).astype(np.float32)
    x[:: max(n // 7, 1)] = rng.normal(0, 1e6, len(x[:: max(n // 7, 1)]))
    return x


def _from_zig(z, anchor=0x42240000):
    """uint32 patterns of a block whose zigzag deltas are ``z`` (z[0] := 0)."""
    z = np.asarray(z, np.uint32).copy()
    z[0] = 0
    d = (z >> np.uint32(1)) ^ (np.uint32(0) - (z & np.uint32(1)))
    return np.uint32(anchor) + np.cumsum(d, dtype=np.uint32)


def _bits(rng, lo, hi, n):
    return rng.integers(lo, hi, n, dtype=np.uint64).astype(np.uint32)


def _outliers(rng, k):
    """4-bit zigzag deltas with ``k`` 20-bit outliers."""
    z = _bits(rng, 8, 16, 1024)
    z[rng.choice(np.arange(1, 1024), k, replace=False)] = _bits(rng, 1 << 19, 1 << 20, k)
    return _from_zig(z).view(np.float32)


def _tie(rng):
    """cost(w=1) = 1024 + 48 * 64 = cost(w=4): the smaller width wins."""
    z = np.ones(1024, np.uint32)
    z[rng.choice(np.arange(1, 1024), 64, replace=False)] = _bits(rng, 8, 16, 64)
    return _from_zig(z).view(np.float32)


def _specials(rng, n=3000):
    x = (np.cumsum(rng.normal(0, 1e-4, n)) + 41.1).astype(np.float32).view(np.uint32)
    pool = np.array([0x7FC00001, 0xFFA00005, 0x7F800001, 0x7F800000, 0xFF800000, 0x0,
                     0x80000000, 0x1, 0x80000001, 0x007FFFFF], np.uint32)
    x[rng.integers(0, n, 60)] = pool[rng.integers(0, pool.size, 60)]
    return x.view(np.float32)


def _assert_same_stream(js, ts):
    for f in FIELDS:
        a = np.asarray(getattr(js, f))
        b = getattr(ts, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b), f
    assert js.n_values == ts.n_values


def _check_against_reference(x, *, pallas=True):
    """Encode in both packages, compare streams and bytes, decode across."""
    want_dtype = np.int32 if np.asarray(x).dtype == np.int32 else np.float32
    ts = tfd.encode(x, device="cpu")
    jr = jfd.encode(x, use_pallas=False)
    _assert_same_stream(jr, ts)
    if pallas:
        _assert_same_stream(jfd.encode(x, use_pallas=True), ts)
    buf = tfd.to_bytes(ts)
    assert buf == jfd.to_bytes(jr)
    assert ts.compact_bits() == jr.compact_bits()
    flat = np.asarray(x).reshape(-1).view(np.int32)
    assert np.array_equal(tfd.decode(ts, out_dtype=torch.int32).numpy(), flat)
    assert np.array_equal(tfd.decompress_array(buf, np.shape(x), want_dtype, device="cpu")
                          .view(np.int32).reshape(-1), flat)
    # the reference decodes the port's bytes and the port the reference's
    assert np.array_equal(np.asarray(jfd.decode(jfd.from_bytes(buf), use_pallas=False))
                          .view(np.int32), flat.view(np.float32).view(np.int32))
    back = tfd.from_bytes(jfd.compress_array(x), device="cpu")
    _assert_same_stream(jr, back)
    return ts


@pytest.mark.parametrize("gen", ["smooth", "random", "constant", "mixed"])
@pytest.mark.parametrize("n", [1, 1000, 1024, 4096, 5000])
def test_codec_matches_reference(rng, gen, n):
    _check_against_reference(_gen(rng, gen, n))


@pytest.mark.parametrize("case", ["outliers_64", "outliers_65", "cost_tie", "specials",
                                  "int32", "ragged"])
def test_codec_adversarial_matches_reference(rng, case):
    x = {"outliers_64": lambda: _outliers(rng, 64),
         "outliers_65": lambda: _outliers(rng, 65),
         "cost_tie": lambda: _tie(rng),
         "specials": lambda: _specials(rng),
         "int32": lambda: rng.integers(-5000, 5000, 3000).astype(np.int32),
         "ragged": lambda: (np.cumsum(rng.normal(0, 1e-3, 3 * 1024 + 333)) - 8.6)
         .astype(np.float32).reshape(3, -1)}[case]()
    ts = _check_against_reference(x)
    want = {"outliers_64": (4, 64), "outliers_65": (20, 0), "cost_tie": (1, 64)}.get(case)
    if want is not None:
        assert (int(ts.widths[0]), int(ts.exc_count[0])) == want


def test_codec_empty_input_matches_reference():
    x = np.zeros(0, np.float32)
    ts = _check_against_reference(x)
    assert ts.n_blocks == 1 and ts.n_values == 0 and int(ts.widths[0]) == 0
    assert tfd.decompress_array(tfd.compress_array(x, device="cpu"), (0,),
                                device="cpu").shape == (0,)


def test_codec_rejects_other_dtypes():
    for x in (np.zeros(8, np.float64), np.zeros(8, np.int16), torch.zeros(8, dtype=torch.int64)):
        with pytest.raises(TypeError, match="32-bit"):
            tfd.encode(x, device="cpu")


@pytest.mark.parametrize("w", (0,) + tref.WIDTHS)
def test_every_width_packs_like_reference(rng, w):
    """A block whose zigzag deltas all have exactly w bits encodes at width
    w, with the reference's packed words; decode restores it."""
    if w == 0:
        x = np.full(1024, np.float32(-3.25))
    else:
        x = _from_zig(_bits(rng, 1 << (w - 1), 1 << w, 1024)).view(np.float32)
    ts = _check_against_reference(x, pallas=w in (0, 3, 10, 32))
    assert int(ts.widths[0]) == w and int(ts.exc_count[0]) == 0
    assert int(tref.payload_words(ts.widths)[0]) == 32 * w
    assert not ts.packed[0, 32 * w:].any()


def test_width_law_and_exceptions(rng):
    """The reference's width-law and exception-path cases."""
    x = np.zeros((1, 1024), np.float32)
    xi = x.view(np.int32)
    xi[0, 1:] = np.arange(1023) % 3          # deltas {1, 1, -2}: zigzag max 3 -> w = 2
    outs = tref.encode_blocks_ref(torch.from_numpy(x))
    assert int(outs[1][0]) == 2
    xi[0, 1] = 300                           # one 11-bit outlier: an exception, w stays 2
    outs = tref.encode_blocks_ref(torch.from_numpy(x))
    assert int(outs[1][0]) == 2 and int(outs[5][0]) >= 1
    _check_against_reference(x)
    y = (np.cumsum(rng.normal(0, 1e-4, 1024)) + 40).astype(np.float32)
    y[100] = -1e30
    y[500] = np.float32(np.inf)
    ts = _check_against_reference(y)
    assert int(ts.widths[0]) < 32 and int(ts.exc_count[0]) >= 2


def test_decode_plain_matches_reference_on_duplicate_slots(rng):
    """Outside encode's contract: duplicate live exception positions sum,
    and a width outside the format unpacks as zeros, as in the reference."""
    s = tfd.encode(_specials(rng, 2048), device="cpu")
    args = [t.clone() for t in (s.packed, s.widths, s.anchors, s.exc_idx, s.exc_val, s.exc_count)]
    args[3][0, :3] = 17
    args[4][0, :3] = torch.tensor([5, 9, -2], dtype=torch.int32)
    args[5][0] = 3
    args[1][1] = 5
    from repro.kernels.fp_delta.ref import decode_blocks_ref as jdec
    want = np.asarray(jax.jit(jdec)(*[a.numpy() for a in args])).view(np.int32)
    got = tref.decode_blocks_ref(*args).view(torch.int32).numpy()
    assert np.array_equal(got, want)


def test_stream_size_bits_matches_reference(rng):
    from repro.kernels.fp_delta import ref as jref

    widths = rng.choice(np.array((0,) + tref.WIDTHS, np.int32), 50)
    counts = rng.integers(0, 65, 50).astype(np.int32)
    assert tref.stream_size_bits(torch.from_numpy(widths), torch.from_numpy(counts)) == int(
        jref.stream_size_bits(widths, counts))


def test_launch_counter_is_thread_safe():
    """8 threads x 10,000 bumps of one wrapper's counter count exactly,
    with the interpreter switching threads as often as it can."""
    def fn():
        pass

    fn.launches = 0

    def work():
        for _ in range(10_000):
            _build.bump(fn)

    threads = [threading.Thread(target=work) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert fn.launches == 80_000


# ------------------------------------------- the encode kernel's width algebra
CANDIDATES = (0,) + tref.WIDTHS[:-1]
KEY32 = ((tref.MINIBLOCK * 32) << 6) | 32


def _n_below(nb: torch.Tensor) -> torch.Tensor:
    """Candidates below each bit length, by the kernel's closed form."""
    return torch.where(nb <= 4, nb, torch.where(nb <= 12, 4 + ((nb - 3) >> 1),
                                                torch.where(nb <= 24, 8 + ((nb - 9) >> 2), 12)))


def _argmin_width(nbits: torch.Tensor) -> torch.Tensor:
    """The encode kernel's width choice on (n, 1024) bit lengths. Lane l
    holds values 32l..32l+31 and adds, for each, the thermometer code of
    the candidates below its bit length into 6-bit fields, five to a 32-bit
    word (three words); one warp sum per candidate gives n_over; then the
    minimum key (cost << 6 | w) over the feasible candidates and w = 32."""
    n, m = nbits.shape
    k = len(CANDIDATES)
    below = _n_below(nbits)                                  # [block, t]
    acc = []
    for word in range(3):
        code = torch.zeros_like(below)
        for c in range(5 * word, min(5 * word + 5, k)):
            code = code + ((below > c).to(torch.int64) << (6 * (c % 5)))
        acc.append(code.reshape(n, 32, 32).sum(2))           # [block, lane]: 32 values each
    assert all(int(a.max()) < 2 ** 32 for a in acc)
    fields = torch.stack([(acc[c // 5] >> (6 * (c % 5))) & 63 for c in range(k)], -1)
    n_over = fields.sum(1)                                   # [block, candidate]
    w = torch.tensor(CANDIDATES, dtype=torch.int64)
    key = torch.where(n_over <= tref.MAX_EXC, ((m * w + tref.EXC_BITS * n_over) << 6) | w, KEY32)
    return (torch.cat([key, torch.full((n, 1), KEY32)], 1).min(1).values & 63)


def test_n_below_counts_candidates():
    nb = torch.arange(33)
    want = torch.tensor([sum(w < b for w in CANDIDATES) for b in range(33)])
    assert torch.equal(_n_below(nb), want)


def _check_width_forms(nbits: np.ndarray) -> torch.Tensor:
    from repro.kernels.fp_delta.ref import choose_width as jchoose

    t = torch.from_numpy(nbits.astype(np.int64))
    got = _argmin_width(t)
    assert torch.equal(got, tref.choose_width(t))
    assert np.array_equal(got.numpy(), np.asarray(jchoose(nbits.astype(np.int32))[0]))
    return got


@pytest.mark.parametrize("k", [0, 1, 63, 64, 65, 1023])
@pytest.mark.parametrize("w", (0,) + tref.WIDTHS)
def test_argmin_width_equals_choose_width(rng, w, k):
    """Blocks whose bit lengths all lie at or under w, with k of them
    raised to w + 1 or to 32 (64 is the exception limit, 65 one over it)."""
    rows = []
    for hi in (min(w + 1, 32), 32):
        for lo_mix in (True, False):
            nb = np.full(1024, w, np.int64)
            if lo_mix:
                nb = rng.integers(0, w + 1, 1024)
            nb[rng.choice(1024, k, replace=False)] = hi
            rows.append(nb)
    _check_width_forms(np.stack(rows))


@pytest.mark.parametrize("pair", [(0, 3), (1, 4), (3, 6)])
def test_argmin_width_keeps_the_smaller_width_on_a_tie(rng, pair):
    """cost(w1) = 1024 w1 + 48 * 64 = 1024 w2 = cost(w2) when the 64 longest
    values have w2 bits: both forms keep w1."""
    w1, w2 = pair
    nb = rng.integers(0, w1 + 1, 1024)
    nb[rng.choice(1024, 64, replace=False)] = w2
    assert int(_check_width_forms(nb[None])[0]) == w1


def test_argmin_width_on_random_bit_lengths(rng):
    """Random mixes: a base width with a spread below it and a geometric
    tail of longer values."""
    base = rng.choice(np.array((0,) + tref.WIDTHS), 400)
    spread = rng.integers(0, 33, (400, 1024))
    nb = np.minimum(np.maximum(base[:, None] - spread % 5, 0)
                    + (rng.geometric(0.9, (400, 1024)) - 1) * rng.integers(0, 8, (400, 1)), 32)
    _check_width_forms(nb)


# ------------------------------------------ the decode kernel's lane algebra
KNOWN_WIDTHS = (0,) + tref.WIDTHS
_U32 = (1 << 32) - 1


def _lane_unpack(packed: np.ndarray, w: int) -> np.ndarray:
    """The decode kernel's unpacking at width w on (n, 1024) words: lane l
    reads only its own words [l*w, l*w + w) and takes value k from bit k*w
    of them, with the word index and shift known from k and w; a width
    outside the format, and w = 0, give zeros."""
    n = packed.shape[0]
    if w not in tref.WIDTHS:
        return np.zeros((n, 1024), np.uint32)
    words = packed.view(np.uint32).astype(np.uint64)[:, :32 * w].reshape(n, 32, w)
    z = np.zeros((n, 32, 32), np.uint64)
    for k in range(32):
        j, s = (k * w) >> 5, (k * w) & 31
        v = words[:, :, j] >> np.uint64(s)
        if s + w > 32:
            assert j + 1 < w          # a straddling value never leaves the lane's words
            v |= words[:, :, j + 1] << np.uint64(32 - s)
        z[:, :, k] = v & np.uint64((1 << w) - 1)
    return (z & np.uint64(_U32)).astype(np.uint32).reshape(n, 1024)


def _lane_inject(z, exc_idx, exc_val, exc_count):
    """The kernel's exception step: slots below the count (taken as is,
    capped to 64) with a position in [0, 1024) are live; their positions are
    zeroed, then every live value is added mod 2^32 (the atomics' order
    cannot matter)."""
    z = z.astype(np.uint64).copy()
    for b in range(z.shape[0]):
        live = min(max(int(exc_count[b]), 0), tref.MAX_EXC)
        slots = [(int(exc_idx[b, s]), int(exc_val[b, s]) & _U32) for s in range(live)]
        slots = [(p, v) for p, v in slots if 0 <= p < 1024]
        for p, _ in slots:
            z[b, p] = 0
        for p, v in slots:
            z[b, p] = (z[b, p] + v) & _U32
    return z.astype(np.uint32)


def _lane_scan(z, anchors):
    """Un-zigzag, a serial inclusive sum over each lane's 32 values, a
    5-step warp scan (shift up by 1, 2, 4, 8, 16) of the lane totals, then
    the anchor: all mod 2^32."""
    z = z.astype(np.uint64).reshape(-1, 32, 32)
    d = ((z >> np.uint64(1)) ^ ((np.uint64(0) - (z & np.uint64(1))) & np.uint64(_U32)))
    run = np.cumsum(d, axis=2) & np.uint64(_U32)
    total = run[:, :, -1]
    incl = total.copy()
    for dist in (1, 2, 4, 8, 16):
        up = np.zeros_like(incl)
        up[:, dist:] = incl[:, :-dist]
        incl = (incl + up) & np.uint64(_U32)
    base = (anchors.astype(np.int64).astype(np.uint64)[:, None] + incl - total) & np.uint64(_U32)
    return ((base[:, :, None] + run) & np.uint64(_U32)).astype(np.uint32).reshape(-1, 1024)


def _lane_decode(args) -> np.ndarray:
    packed, widths, anchors, exc_idx, exc_val, exc_count = (np.asarray(a) for a in args)
    z = np.concatenate([_lane_unpack(packed[b:b + 1], int(widths[b]))
                        for b in range(packed.shape[0])])
    return _lane_scan(_lane_inject(z, exc_idx, exc_val, exc_count), anchors).view(np.int32)


def _both_references(args) -> tuple[np.ndarray, np.ndarray]:
    from repro.kernels.fp_delta.ref import decode_blocks_ref as jdec

    port = tref.decode_blocks_ref(*(torch.from_numpy(np.asarray(a)) for a in args))
    jax_out = np.asarray(jax.jit(jdec)(*[np.asarray(a) for a in args]))
    return port.view(torch.int32).numpy(), jax_out.view(np.int32)


def _stream_args(rng, n=3):
    s = tfd.encode(_specials(rng, n * 1024), device="cpu")
    return [t.numpy().copy() for t in (s.packed, s.widths, s.anchors, s.exc_idx, s.exc_val,
                                       s.exc_count)]


@pytest.mark.parametrize("w", KNOWN_WIDTHS + (5, 7, 33, -1, 255))
def test_lane_unpack_equals_reference(rng, w):
    """Random words (also past the 32*w valid ones, which must be ignored)
    at every width and at widths outside the format: the lane-local
    unpacking equals the reference's group unpacking, and the whole lane
    decode equals both plain decodes."""
    import jax.numpy as jnp

    from repro.kernels.fp_delta.ref import unpack_candidate

    packed = rng.integers(0, 2 ** 32, (2, 1024), dtype=np.uint64).astype(np.uint32)
    got = _lane_unpack(packed, w)
    if w in tref.WIDTHS:
        want = np.asarray(unpack_candidate(jnp.asarray(packed, jnp.uint32), w))
        assert np.array_equal(got, want)
    else:
        assert not got.any()
    args = [packed.view(np.int32), np.full(2, w, np.int32),
            rng.integers(-2 ** 31, 2 ** 31, 2).astype(np.int32),
            np.zeros((2, tref.MAX_EXC), np.int32), np.zeros((2, tref.MAX_EXC), np.int32),
            np.zeros(2, np.int32)]
    port, ref_ = _both_references(args)
    assert np.array_equal(_lane_decode(args), port)
    assert np.array_equal(port, ref_)


@pytest.mark.parametrize("zig", ["random", "all_ones", "max_zigzag", "smooth"])
def test_lane_scan_equals_cumsum(rng, zig):
    """The serial-sum plus warp-scan prefix, fed width-32 blocks (whose
    words are the zigzags), equals the plain decodes' cumulative sum mod
    2^32, wrap-around included."""
    n = 4
    z = {"random": lambda: rng.integers(0, 2 ** 32, (n, 1024), dtype=np.uint64),
         "all_ones": lambda: np.ones((n, 1024), np.uint64),
         "max_zigzag": lambda: np.full((n, 1024), _U32, np.uint64),
         "smooth": lambda: rng.integers(0, 64, (n, 1024), dtype=np.uint64)}[zig]()
    z = z.astype(np.uint32)
    args = [z.view(np.int32), np.full(n, 32, np.int32),
            np.array([0, -1, 2 ** 31 - 1, -2 ** 31], np.int32),
            np.zeros((n, tref.MAX_EXC), np.int32), np.zeros((n, tref.MAX_EXC), np.int32),
            np.zeros(n, np.int32)]
    port, ref_ = _both_references(args)
    assert np.array_equal(_lane_scan(z, args[2]).view(np.int32), port)
    assert np.array_equal(port, ref_)


def _malformed(rng, case):
    """Exception slots that encode never writes."""
    args = _stream_args(rng)
    idx, val, cnt = args[3], args[4], args[5]
    if case == "duplicates":
        idx[0, :5] = [17, 17, 17, 900, 900]
        val[0, :5] = [5, 9, -2, 2 ** 31 - 1, 2 ** 31 - 1]     # the 900 pair wraps
        cnt[0] = 5
        idx[1, :64] = 3                                      # all 64 slots on one position
        val[1, :64] = rng.integers(-2 ** 31, 2 ** 31, 64)
        cnt[1] = 64
    elif case == "out_of_range":
        idx[0, :6] = [-1, 1024, 65535, 0, 1023, -2 ** 31]
        val[0, :6] = rng.integers(-2 ** 31, 2 ** 31, 6)
        cnt[0] = 6
    elif case.startswith("count_"):
        c = int(case.split("_")[1].replace("m", "-"))
        idx[:] = rng.integers(0, 1024, idx.shape)
        idx[:, 10:20] = 500                                  # duplicates among them
        val[:] = rng.integers(-2 ** 31, 2 ** 31, val.shape)
        cnt[:] = c
    elif case == "unknown_widths":
        args[1][:] = [5, 33, -1]
    return args


@pytest.mark.parametrize("case", ["duplicates", "out_of_range", "count_m1", "count_0",
                                  "count_64", "count_255", "unknown_widths"])
def test_lane_exceptions_equal_reference(rng, case):
    """Duplicate live slots sum, out-of-range positions (-1, 1024, 65535)
    are dropped, and counts of -1, 0, 64 and 255 take 0, 0, 64 and 64
    slots: the kernel's zero-then-add step equals both plain decodes."""
    args = _malformed(rng, case)
    port, ref_ = _both_references(args)
    assert np.array_equal(port, ref_)
    assert np.array_equal(_lane_decode(args), port)
