"""The page stream's compact form (``build_page_stream``) and its expansion
into the decode's token descriptors, held against the JAX package.

Pages are stored by the port's encoder from a seed (``tests/stream_cases.py``)
and planned by both packages from the same bytes. The port's compact stream
must carry what the reference's plans hold, and its plain host expansion
(``expand_stream_ref``, the ``tok_off``/``nbits``/``anchor`` properties)
must give the reference's arrays byte for byte. The CUDA kernel itself is
held against the plain expansion in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.core.fp_delta import fp_delta_plan as j_fp_delta_plan  # noqa: E402
from repro.core.pages import PageMeta as JPageMeta  # noqa: E402
from repro.core.pages import page_stream_plan as j_page_stream_plan  # noqa: E402
from repro.kernels import fp_delta as jfd  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core.fp_delta import fp_delta_encode, fp_delta_plan  # noqa: E402
from repro_torch.kernels import fp_delta as tfd  # noqa: E402
from repro_torch.kernels.fp_delta import ops as tops  # noqa: E402
from stream_cases import CASES, port_plans, raw_meta, stored_pages  # noqa: E402

STREAM_BLOCK = tfd.STREAM_BLOCK


def _jax_plans(pages, dtype):
    dtype = np.dtype(dtype)
    return [j_page_stream_plan(b, JPageMeta(**raw_meta(len(b), n)), dtype, "none")
            if enc == "raw" else j_fp_delta_plan(b, n, dtype) for b, n, enc in pages]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", list(CASES))
def test_compact_stream_expands_to_the_reference_arrays(case, dtype):
    """The compact stream holds the plans' pages and escapes; its host
    expansion and the CPU ``DeviceStream`` equal the
    JAX package's ``build_page_stream`` arrays byte for byte."""
    pages = stored_pages(np.random.default_rng(11), case, dtype)
    tp = port_plans(pages, dtype)
    js = jfd.build_page_stream(_jax_plans(pages, dtype))
    ts = tfd.build_page_stream(tp)
    if case == "no_escapes":
        assert all(p.n_escapes == 0 and p.n > 0 for p in tp)
    if case == "few_escapes":  # the fixpoint resolver, an escape at the last token
        assert all(1 <= p.n_escapes <= 4 and p.flags[-1] for p in tp)
    if case == "many_escapes":  # the candidate scan
        assert all(p.n_escapes > 4 for p in tp)
    if case == "exact_blocks":
        assert ts.n_values == 2 * STREAM_BLOCK
    if case == "raw":
        assert sum(p.n == 0 for p in tp if p.n_values > 1) == 1

    # the compact form
    assert np.array_equal(ts.words32, js.words32) and ts.words32.dtype == np.int32
    assert ts.width == js.width and ts.counts == js.counts
    assert ts.shape == js.tok_off.shape
    full = [p for p in tp if p.n_values]
    starts = np.cumsum([0] + [p.n_values for p in full])[:-1]
    # rows: value start, value count, base bit, n, first escape index
    assert ts.page_table.dtype == np.int32 and ts.page_table.shape == (5, len(full))
    assert np.array_equal(ts.page_table[0], starts)
    assert np.array_equal(ts.page_table[1], [p.n_values for p in full])
    assert np.array_equal(ts.page_table[2],
                          64 * np.cumsum([0] + [len(p.words) - 1 for p in full])[:-1])
    assert np.array_equal(ts.page_table[3], [p.n for p in full])
    esc = [np.flatnonzero(p.flags) + s + 1 for p, s in zip(full, starts)]
    esc = np.concatenate(esc) if esc else np.zeros(0, np.int64)
    assert ts.escapes.dtype == np.int32 and np.array_equal(ts.escapes, esc)
    assert np.array_equal(ts.page_table[4],
                          np.cumsum([0] + [int(p.flags.sum()) for p in full])[:-1])

    # the expansions
    want = (js.tok_off, js.nbits, js.anchor)
    got = tops.expand_stream_ref(ts)
    ds = tfd.stream_from_numpy(ts, device="cpu")
    for name, w, g, d in zip(("tok_off", "nbits", "anchor"), want, got,
                             (ds.tok_off, ds.nbits, ds.anchor)):
        assert g.dtype == w.dtype == np.int32 and np.array_equal(g, w), name
        assert np.array_equal(getattr(ts, name), w), name
        assert np.array_equal(d.numpy(), w), name
    pad = ts.shape[0] * STREAM_BLOCK - ts.n_values
    assert pad == 0 if case == "exact_blocks" else pad > 0
    assert (got[0].reshape(-1)[ts.n_values:] == 0).all()
    assert (got[1].reshape(-1)[ts.n_values:] == ts.width).all()
    assert (got[2].reshape(-1)[ts.n_values:] == 1).all()


def _refine_case(rng, dtype, n_rec=90):
    counts = rng.integers(0, 40, n_rec)
    counts[[0, 5, n_rec - 1]] = 0
    x = (np.cumsum(rng.normal(0, 1e-3, int(counts.sum()))) + 40.7).astype(dtype)
    y = (np.cumsum(rng.normal(0, 1e-3, int(counts.sum()))) - 8.6).astype(dtype)
    x[rng.integers(0, len(x), 30)] = 1e25
    cut = [0, 30, 31, 60, n_rec]  # a pair of empty pages in the middle
    vs = np.concatenate([[0], np.cumsum(counts)])
    stored, pairs = [], []
    for r0, r1 in zip(cut[:-1], cut[1:]):
        for v in (x[vs[r0]:vs[r1]], y[vs[r0]:vs[r1]]):
            stored.append((fp_delta_encode(v)[0] if len(v) else b"", len(v), "fp_delta"))
        pairs.append((r0, r1))
    return stored, pairs, counts


def _ids(plans, chosen):
    return [next(k for k, q in enumerate(plans) if q is p) for p in chosen]


def test_refine_aux_and_chunks_need_no_expansion(rng, monkeypatch):
    """``build_refine_aux`` and ``chunk_plan_pairs`` give the reference's
    outputs on the compact stream and never expand it on the host."""
    for dtype in (np.float32, np.float64):
        stored, pairs, counts = _refine_case(rng, dtype)
        tp, jp = port_plans(stored, dtype), _jax_plans(stored, dtype)
        # a small cap: several fused chunks
        monkeypatch.setattr(tops, "_MAX_LAUNCH_BITS", 64 * 120)
        monkeypatch.setattr(jfd.ops, "_MAX_LAUNCH_BITS", 64 * 120)
        tchunks = list(tfd.chunk_plan_pairs(tp, pairs))
        jchunks = list(jfd.chunk_plan_pairs(jp, pairs))
        assert len(tchunks) == len(jchunks) > 1
        obs.enable()
        try:
            for tc, jc in zip(tchunks, jchunks):
                assert tc[0] == jc[0] and tc[2] == jc[2] and tc[3] == jc[3]
                assert _ids(tp, tc[1]) == _ids(jp, jc[1])
                if tc[0] != "dev":
                    continue
                rl, rh = tc[3]
                local = [(a - rl, b - rl) for a, b in tc[2]]
                ts, js = tfd.build_page_stream(tc[1]), jfd.build_page_stream(jc[1])
                ta = tfd.build_refine_aux(ts, local, counts[rl:rh])
                ja = jfd.build_refine_aux(js, local, counts[rl:rh])
                for f in ("seg_flag", "end_pos", "valid", "x_start", "y_start", "counts"):
                    a, b = getattr(ta, f), getattr(ja, f)
                    assert a.dtype == b.dtype and np.array_equal(a, b), f
                assert ta.n_records == ja.n_records
                assert "_expanded" not in vars(ts)
            counters = obs.snapshot()["counters"]
            assert counters.get("stream.expand.host_values", 0) == 0
        finally:
            obs.disable()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cpu_stream_refuses_payload_claiming_more_escapes_than_markers(dtype):
    """A payload whose length claims one more escape than its markers hold
    (a malformed page) is refused when the CPU stream is built, not
    expanded into wrong descriptors; the card refuses it too
    (``tests/test_torch_escape_resolve.py``)."""
    payload, n, _ = stored_pages(np.random.default_rng(11), "few_escapes", dtype)[0]
    good = fp_delta_plan(payload, n, np.dtype(dtype))
    tfd.stream_from_numpy(tfd.build_page_stream([good]), device="cpu")  # well formed
    bad = fp_delta_plan(payload + bytes(np.dtype(dtype).itemsize), n, np.dtype(dtype))
    assert bad.n_escapes == good.n_escapes + 1
    ts = tfd.build_page_stream([good, bad])
    with pytest.raises(ValueError, match="do not follow its escapes"):
        tfd.stream_from_numpy(ts, device="cpu")
    with pytest.raises(ValueError, match="do not follow its escapes"):
        tfd.decode_page_stream(ts, device="cpu")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_build_page_stream_refuses_payload_shorter_than_its_tokens(dtype):
    """A payload cut inside its tokens (its escape count reads 0) is refused
    by the stream build on every device, before any word is copied."""
    payload, n, _ = stored_pages(np.random.default_rng(11), "no_escapes", dtype)[0]
    plan = fp_delta_plan(payload[: len(payload) // 2], n, np.dtype(dtype))
    assert plan.n_escapes == 0
    with pytest.raises(ValueError, match="shorter than its header's tokens"):
        tfd.build_page_stream([plan])
