#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on an NVIDIA GPU and hold it to account.

Usage (from the repository root, on a machine with one CUDA card)::

    python3 chip_smoke.py                 # full size: 1,710,670 Porto taxi trips
    python3 chip_smoke.py --n-traj 20000  # a cut, printed as {"reduced": ...}

Phases, each fatal on failure (nothing is caught):

1. the card's name and power limit; build every CUDA kernel from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, all started together);
2. the file path, with every kernel's launch count set to 0 just before:
   ``write_file`` of a Hilbert-sorted, checksummed float64 Porto-taxi file
   with three extra columns (``duration_s`` float32 reaches the page-stats
   kernel), then five ``read_columnar`` calls on ``device="cuda"``: bbox
   reads with ``refine=True`` at about 1 %, 10 % and 50 % record
   selectivity, one adding ``filter=Range("duration_s", ...)``, one with
   ``keep_on_device=True``. Each read is held exactly (bit patterns) against
   a numpy oracle computed from the generated columns, independent of both
   packages' readers. Every kernel must have launched at least once;
3. each kernel against its plain PyTorch version on the same CUDA tensors,
   at the main path's shapes and on adversarial inputs (W = 32 and 64,
   escapes, raw pages, NaN, ±inf, ±0, denormals, NaN and all-NaN pages;
   for the decode also a 4.2 M value page with one anchor, all-anchor
   streams, 1, 1,057 and 2,115 stream blocks, two calls back to back and
   four threads calling at once, see :func:`decode_cases`; for the page
   min/max also a 1<<20-value page, 10,000 empty pages among real ones,
   ragged bounds and values 4 and 12 bytes off a 16-byte boundary, calls
   back to back and from four threads, see :func:`minmax_page_cases`);
   the tolerance is exact equality of bit patterns. Times come from CUDA
   events around ten calls after warm-up (``kernel_ms``) and from a
   ``torch.profiler`` trace of ten more (``device_ms``: the kernels' own
   time, without host dispatch);
4. the LM path, with every launch count set to 0 just before: qwen3-8b at
   its published widths and depth (36 layers, d_model 4096, 32/8 heads,
   head_dim 128, qk-norm, vocab 151936; bf16 compute over float32
   parameters drawn on the card from a seeded generator) with
   ``attn_impl="flash"``: ``forward`` on (2, 4096) tokens (train_4k's
   sequence length, its batch of 256 cut to 2) must launch the flash kernel
   once per layer; a ``BatchedServer(max_batch=4, max_len=256)`` then
   answers 8 requests of 16-64 random tokens, 16 new tokens each, as a
   functional check; a second server (``max_batch=32``) answers 256 such
   requests of 128 new tokens, submitted at once, and its wall time,
   tokens/s and TTFT / latency percentiles are the serving measurement. The
   logits are held against the same forward with the plain attention
   (``attn_impl="ref"``) and both against a float32 forward (see
   :func:`lm_path` for the rules). A ``torch.profiler`` trace of one more
   forward and of one decode step (batch 32) splits their device time by
   kernel group. Then the float32 route, every count set to 0 just before:
   the same forward in float32 compute with ``attn_impl="flash"`` must
   launch the CUDA-core flash kernel once per layer (and the sm90 kernel
   never) and lie no farther from the float32 plain forward than the bf16
   plain forward does;
5. both flash kernels against their plain version through ``ops.attention``
   (see :func:`check_flash` for the tolerances): bf16 (the sm90 ``wgmma``
   kernel) and float32 (the CUDA-core kernel) at the LM path's shape and at
   the reference's six test shapes (GQA, rectangular, single-token,
   ragged, non-causal); then the times at the LM shape of the sm90 kernel,
   the plain version and SDPA (a yardstick the port never calls) on bf16
   inputs, and of the CUDA-core kernel, the plain version and SDPA on
   float32 ones.

Between phases 3 and 4 run the four paths added after them, in the order
3a, 3c, 3d, 3b (3c and 3d read the lake 3a writes):

3a. the dataset path, with every launch count set to 0 just before:
    ``write_dataset`` of the same Porto columns and extras into 16
    Hilbert-partitioned shards on ``device="cuda"``, then five
    ``SpatialDatasetScanner(max_workers=4).scan`` calls on ``"cuda"`` with
    the file path's boxes, filter and ``keep_on_device``. Each scan is held
    exactly against the numpy oracle in the dataset's record order (one
    global Hilbert sort split 16 ways), and its ``ReadStats`` (shards and
    pages read and total, records) against the oracle's own shard and page
    layout. Kernels 1-3 must each launch;
3b. the codec path, with every launch count set to 0 just before:
    ``compress_array`` then ``decompress_array`` on the card of the Porto x
    and y columns cast to float32, exact to the bit, with the compressed
    size against the host paper-exact ``fp_delta_encode`` of the same
    array. Then both codec kernels against their plain versions at that
    shape and on adversarial blocks (see :func:`codec_blocks`; and 1, 7
    and 5,000 blocks drawn from them), exact in all six encode outputs and
    the decoded bits; and the decode on streams encode never writes
    (:func:`decode_malformed`: repeated live exception slots, which sum,
    positions and counts out of range, unknown widths), exact against the
    plain version;
3c. the serve path, over the lake of 3a, with every launch count set to 0
    just before each server: ``SpatialQueryServer(device="cuda",
    cache_rgs=32, max_wave=64)`` answers 1, 16 and 64 bbox queries (boxes
    cycling 1, 5, 10, 25 and 50 % record selectivity, the reference serve
    benchmark's traffic), each count on a fresh server; the 64-query server
    then answers the same 64 boxes again, which must decode nothing (no
    ``device.refine_multi_launch`` span, no kernel launch: the row groups
    come from the cache on the card). Every query is held exactly against
    the dataset oracle (coordinates, extras, ``ReadStats``); after
    ``invalidate()`` the device memory must be back at its level from
    before the server. The five distinct boxes as solo sequential
    ``scan(refine=True, parallel=False)`` calls give the unshared baseline.
    Kernels 1 and 2 must launch in each wave of decodes; every counter is
    read after every wave and summed into ``launches_serve``. Kernels 1
    and 2 are then timed once at the serve tier's own shape (a whole row
    group's first device chunk, ``serve_shape`` on their kernel lines),
    held against their plain versions there;
3d. the data feed, every count set to 0 just before: ``Prefetcher(
    TrajectoryBatcher([lake], GeoTokenizer(PORTO_BBOX, order=6),
    seq_len=128, global_batch=16, bbox=<the 10 % box>, loop=False))`` (the
    reference pipeline benchmark's settings) run to its end on ``"cuda"``,
    then the same on ``"host"``: every batch equal bit for bit, kernels 1
    and 2 launched on the card and nothing on the host.

Every line is one JSON object. The kernel names are printed early under
``kernel_names``, so the only line keyed ``kernels`` is the per-kernel
table, printed just before the last line, ``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository's sources beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FULL_N_TRAJ = 1_710_670          # ECML/PKDD 2015 taxi-trajectory challenge trips
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak (data sheet)
FP32_FLOPS_PER_S = 67e12         # H100 SXM float32 peak outside the tensor cores (data sheet)
KERNEL_LIBS = ("fp_delta_decode", "segminmax_refine", "page_minmax", "flash_attention",
               "flash_attention_sm90", "miniblock")
FILE_KERNELS = ("fp_delta.decode_stream", "minmax.segminmax_refine", "minmax.page_minmax")
CODEC_KERNELS = ("fp_delta.encode_blocks", "fp_delta.decode_blocks")
LM_KERNELS = ("flash_attention.flash_attention_sm90",)
F32_FLASH = "flash_attention.flash_attention_f32"   # the float32 route: its own forward
DATASET_SHARDS = 16            # ~107 k trips, ~5 M points a shard: a typical lake file
DATASET_WORKERS = 4
LM_CONFIG = "qwen3-8b"
LM_BATCH, LM_SEQ, LM_FULL_BATCH = 2, 4096, 256   # train_4k: seq 4096, global batch 256
# Serving: prompts of 16-64 tokens (a tokenized trip prefix, as examples/serve_lm.py
# sends, up to a whole Porto trip of about 48 points) in a cache of 256 positions.
SERVE_MAX_LEN = 256
SERVE_CHECK_REQUESTS = 8                        # functional check, max_batch 4, 16 new tokens
SERVE_LOAD = (256, 32, 128)                      # requests, max_batch, max_new_tokens
# Serve path: the reference serve benchmark's traffic (benchmarks/bench_serve.py):
# boxes cycle these record selectivities; the whole lake fits in the cache.
QUERY_FRACS = (0.01, 0.05, 0.10, 0.25, 0.50)
SERVE_COUNTS = (1, 16, 64)                      # the reference's 256 cut to one full wave
SERVE_MAX_WAVE, SERVE_CACHE_RGS = 64, 32
SERVE_SPANS = ("device.h2d", "device.refine_multi_launch", "device.refine_cached",
               "device.gather")
# Data feed: the reference pipeline benchmark's settings (benchmarks/bench_pipeline.py)
FEED_SEQ, FEED_BATCH = 128, 16
DEVICE = "cuda"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Failure(Exception):
    pass


def require(cond, what: str) -> None:
    if not cond:
        raise Failure(what)


def ragged(starts, counts) -> np.ndarray:
    """Concatenated ``arange(s, s + c)`` per pair (the oracle's own gather)."""
    counts = np.asarray(counts, np.int64)
    if counts.sum() == 0:
        return np.zeros(0, np.int64)
    excl = np.cumsum(counts) - counts
    return (np.repeat(np.asarray(starts, np.int64) - excl, counts)
            + np.arange(int(counts.sum()), dtype=np.int64))


def ibits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int64 if a.dtype.itemsize == 8 else np.int32)


# ---------------------------------------------------------------- the data
def make_data(n_traj: int, seed: int):
    from repro_torch.data.synthetic import porto_taxi_like

    cols = porto_taxi_like(n_traj=n_traj, seed=seed)
    rng = np.random.default_rng(seed + 1)
    starts = cols.record_value_starts()
    npts = np.diff(np.append(starts, cols.n_values))
    extra = {
        # trip start, seconds since 2013-07-01 (the challenge's first day)
        "timestamp": (1372636800 + rng.integers(0, 365 * 86400, n_traj)).astype(np.int64),
        "taxi_id": rng.integers(20000001, 20000449, n_traj).astype(np.int64),
        "duration_s": (15.0 * (npts - 1)).astype(np.float32),
    }
    schema = {"timestamp": "<i8", "taxi_id": "<i8", "duration_s": "<f4"}
    return cols, npts, extra, schema


def file_order(cols, row_group_records: int) -> np.ndarray:
    """Input record index of each record in file order: the writer sorts each
    row group by the Hilbert key of record bbox centres (stable)."""
    from repro_torch.core.sfc import sort_keys
    from repro_torch.core.writer import record_centroids

    n = cols.n_records
    parts = []
    for r0 in range(0, n, row_group_records):
        r1 = min(n, r0 + row_group_records)
        sub = cols.slice_records(r0, r1)
        if r1 - r0 > 1:
            cx, cy = record_centroids(sub)
            perm = np.argsort(sort_keys(cx, cy, "hilbert", 16), kind="stable")
        else:
            perm = np.arange(r1 - r0)
        parts.append(r0 + perm)
    return np.concatenate(parts)


class Oracle:
    """Expected read results from the generated columns alone."""

    def __init__(self, cols, npts, extra, order):
        starts = cols.record_value_starts()
        self.x, self.y = cols.x, cols.y
        self.starts, self.npts, self.extra, self.order = starts, npts, extra, order
        self.xmin = np.minimum.reduceat(cols.x, starts)[order]
        self.xmax = np.maximum.reduceat(cols.x, starts)[order]
        self.ymin = np.minimum.reduceat(cols.y, starts)[order]
        self.ymax = np.maximum.reduceat(cols.y, starts)[order]

    def keep(self, bbox, rng_filter=None) -> np.ndarray:
        x0, y0, x1, y1 = bbox
        k = (self.xmin <= x1) & (self.xmax >= x0) & (self.ymin <= y1) & (self.ymax >= y0)
        if rng_filter is not None:
            col, lo, hi = rng_filter
            v = self.extra[col][self.order]
            k &= (v >= lo) & (v <= hi)
        return k

    def expect(self, keep) -> dict:
        """The records ``keep`` selects: their coordinate bits and extras."""
        sel = self.order[keep]
        iv = ragged(self.starts[sel], self.npts[sel])
        return {"n": int(keep.sum()), "x": ibits(self.x[iv]), "y": ibits(self.y[iv]),
                "extra": {k: ibits(np.ascontiguousarray(v[sel])) for k, v in self.extra.items()}}

    def check(self, res, keep, what: str) -> int:
        """Hold a read's result exactly to the records ``keep`` selects."""
        return self.check_expected(res, self.expect(keep), what)

    def check_expected(self, res, want: dict, what: str) -> int:
        """:meth:`check` against an :meth:`expect` computed once."""
        geo, extras, stats = res
        n = want["n"]
        require(stats.records_returned == n,
                f"{what}: {stats.records_returned} records returned, oracle {n}")
        geo = geo.coords_to_host()
        require(np.array_equal(ibits(geo.x), want["x"]), f"{what}: x bits differ")
        require(np.array_equal(ibits(geo.y), want["y"]), f"{what}: y bits differ")
        for k, v in want["extra"].items():
            require(np.array_equal(ibits(np.ascontiguousarray(extras[k])), v),
                    f"{what}: extra {k!r} differs")
        return n


def selectivity_bbox(oracle: Oracle, target: float):
    """A box from the data's lower-left corner whose record selectivity is
    near ``target`` (the quantile box of the README's refine sweep)."""
    cx = (oracle.xmin + oracle.xmax) / 2
    cy = (oracle.ymin + oracle.ymax) / 2
    f = float(np.sqrt(target))
    return (float(oracle.xmin.min()), float(oracle.ymin.min()),
            float(np.quantile(cx, f)), float(np.quantile(cy, f)))


# ---------------------------------------------------------------- timing
def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, iters: int = 10, warmup: int = 2):
    """Device time per call of ``fn``: the durations of the kernels and
    memsets it launched, summed over a ``torch.profiler`` trace of
    ``iters`` back-to-back calls. Beside :func:`cuda_ms` (events around
    the same calls), it splits device time from host dispatch. A trace that
    shows no device activity is taken again, twice at most; then the time
    is None ("not measured") and a line says so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / iters / 1e3
    emit({"device_ms": "not measured: three profiler traces showed no device activity"})
    return None


def read_split(tracer, wall_s: float) -> dict:
    """Host plan / H2D / device / D2H seconds of one traced read. Launches
    are asynchronous: device time lands in the span that waits for it
    (the record-mask transfer in device.refine_launch)."""
    tot = {r["name"]: r["total_ms"] / 1e3 for r in tracer.summary()}
    h2d = tot.get("device.h2d", 0.0)
    dev = tot.get("device.decode_launch", 0.0) + tot.get("device.refine_launch", 0.0)
    d2h = tot.get("device.gather", 0.0)
    return {"wall_s": wall_s, "host_plan_s": wall_s - h2d - dev - d2h,
            "h2d_s": h2d, "device_s": dev, "d2h_s": d2h}


# ---------------------------------------------------------------- main path
def main_path(data, path: Path, counters) -> dict:
    import torch

    from repro_torch import obs
    from repro_torch.core.filters import Range
    from repro_torch.core.reader import SpatialParquetReader
    from repro_torch.core.writer import write_file

    cols, npts, extra, schema = data
    order = file_order(cols, 1 << 20)
    oracle = Oracle(cols, npts, extra, order)
    boxes = {f"refine_{int(t * 100)}pct": selectivity_bbox(oracle, t)
             for t in (0.01, 0.10, 0.50)}
    rng_filter = ("duration_s", 300.0, 900.0)

    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    write_file(path, columns=cols, extra=extra, extra_schema=schema,
               sort="hilbert", checksums=True, device=DEVICE)
    write_s = time.perf_counter() - t0
    reads = {}
    with SpatialParquetReader(path) as r:
        plan = [(name, dict(bbox=b, refine=True), oracle.keep(b))
                for name, b in boxes.items()]
        b10 = boxes["refine_10pct"]
        plan.append(("refine_10pct_filter",
                     dict(bbox=b10, refine=True, filter=Range(*rng_filter)),
                     oracle.keep(b10, rng_filter)))
        plan.append(("refine_10pct_keep_on_device",
                     dict(bbox=b10, refine=True, keep_on_device=True),
                     oracle.keep(b10)))
        for name, kw, keep in plan:
            tracer = obs.enable()
            t0 = time.perf_counter()
            res = r.read_columnar(device=DEVICE, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            obs.disable()
            n = oracle.check(res, keep, name)
            st = res[2]
            reads[name] = {**read_split(tracer, wall), "records": n,
                           "selectivity": n / oracle.order.size,
                           "pages_read": st.pages_read, "pages_total": st.pages_total,
                           "bytes_read": st.bytes_read, "bytes_total": st.bytes_total}
    launches = {c.kname: c.launches for c in counters}
    for name in FILE_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the file path")
    return {"write_s": write_s, "file_bytes": path.stat().st_size,
            "n_records": int(cols.n_records), "n_points": int(cols.n_values),
            "reads": reads, "launches": launches,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "_oracle": oracle, "_boxes": boxes}


# ---------------------------------------------------------------- kernel checks
def rg0_stream(path: Path, oracle: Oracle):
    """The first fused launch of row group 0, built as the reader builds it."""
    from repro_torch.core.pages import PageMeta, page_stream_plan
    from repro_torch.core.reader import SpatialParquetReader
    from repro_torch.kernels.fp_delta import build_page_stream, build_refine_aux, chunk_plan_pairs

    with SpatialParquetReader(path) as r:
        rg = r.footer["row_groups"][0]
        plans, pairs = [], []
        for mx, my in zip(rg["x_pages"], rg["y_pages"]):
            for m in (mx, my):
                meta = PageMeta.from_dict(m)
                blob = r._source.read_at(meta.offset, meta.nbytes)
                plans.append(page_stream_plan(blob, meta, r.coord_dtype, r.codec))
            pairs.append((mx["rec_start"], mx["rec_start"] + mx["rec_count"]))
        vcounts = oracle.npts[oracle.order[: rg["n_records"]]]
        for kind, cplans, cpairs, (rl, rh) in chunk_plan_pairs(plans, pairs):
            if kind == "dev":
                stream = build_page_stream(cplans)
                aux = build_refine_aux(stream, [(a - rl, b - rl) for a, b in cpairs],
                                       vcounts[rl:rh])
                d = oracle.extra["duration_s"][oracle.order[: rg["n_records"]]]
                ebounds = np.array([p["rec_start"] for p in rg["x_pages"]]
                                   + [rg["n_records"]], np.int64)
                return stream, aux, d, ebounds
    raise Failure("row group 0 has no device chunk")


def adversarial_pages(rng, dtype, n: int) -> list[np.ndarray]:
    """Pages with escapes, raw pages and NaN/±inf/±0/denormal values."""
    smooth = (np.cumsum(rng.normal(0, 1e-4, n)) + 41.1).astype(dtype)
    spiky = smooth.copy()
    hits = rng.integers(0, n, max(n // 50, 4))
    spiky[hits] = rng.normal(0, 1e30, len(hits)).astype(dtype)
    specials = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0,
                         np.finfo(dtype).smallest_subnormal,
                         -np.finfo(dtype).smallest_subnormal], dtype)
    spiky[rng.integers(0, n, 40)] = rng.choice(specials, 40)
    uint = np.uint32 if np.dtype(dtype).itemsize == 4 else np.uint64
    wild = rng.integers(0, np.iinfo(uint).max, n, dtype=uint, endpoint=True).view(dtype)
    return [smooth, spiky, wild]


def adversarial_stream(rng, dtype):
    """A stream of fp_delta pages (escape-free, escaped, all-escape) and a raw
    page, with per-record segmentation for the refine kernel."""
    from repro_torch.core.fp_delta import fp_delta_encode, fp_delta_plan
    from repro_torch.core.pages import PageMeta, page_stream_plan
    from repro_torch.kernels.fp_delta import build_page_stream, build_refine_aux

    plans, pairs, vcounts, values = [], [], [], []
    r = 0
    for page in adversarial_pages(rng, dtype, 3000) + ["raw"]:
        if isinstance(page, str):
            page = rng.normal(-8.6, 1.0, 2500).astype(dtype)
            page[::97] = np.nan
            px, py = page, page[::-1].copy()
            metas = [PageMeta(0, p.nbytes, len(p), 0, 0, 0.0, 0.0, "raw", 0, 0) for p in (px, py)]
            plans += [page_stream_plan(p.tobytes(), m, np.dtype(dtype), "none")
                      for p, m in zip((px, py), metas)]
        else:
            px, py = page, np.roll(page, 7)
            for p in (px, py):
                payload, _ = fp_delta_encode(p)
                plans.append(fp_delta_plan(payload, len(p), np.dtype(dtype)))
        c = rng.integers(0, 60, 200)
        c = c[np.cumsum(c) <= len(px)]
        c = np.append(c, len(px) - c.sum())
        vcounts.append(c)
        pairs.append((r, r + len(c)))
        r += len(c)
        values += [px, py]
    stream = build_page_stream(plans)
    aux = build_refine_aux(stream, pairs, np.concatenate(vcounts))
    return stream, aux, values


def adversarial_pages_minmax(rng):
    """float32 column + page bounds: ±0 both orders, NaN pages, all-NaN
    pages, empty pages, infs and denormals."""
    tiny = np.finfo(np.float32).smallest_subnormal
    pages = [np.array([0.0, -0.0], np.float32), np.array([-0.0, 0.0], np.float32),
             np.array([1.0, np.nan, -3.0], np.float32), np.full(5, np.nan, np.float32),
             np.zeros(0, np.float32), np.array([np.inf, -np.inf, tiny, -tiny], np.float32),
             np.array([-np.nan, 2.0], np.float32),
             rng.normal(0, 1e3, 100_000).astype(np.float32)]
    v = np.concatenate(pages)
    bounds = np.concatenate([[0], np.cumsum([len(p) for p in pages])]).astype(np.int64)
    return v, bounds


def minmax_page_cases(rng) -> list[tuple[str, np.ndarray, np.ndarray]]:
    """Kernel 3's large-page cases as (name, float32 values, int64 bounds): a
    single page of 1<<20 values, 10,000 empty pages among 400 real ones
    (with NaN, ±0, ±inf and denormals), bounds that start and end off
    16-byte boundaries with ±0 in both orders."""
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


def anchor_free_plan(rng, dtype, n: int):
    """One fp_delta page of ``n`` values whose bit patterns step by at most
    3000: no escapes, so its first value is its only anchor and the
    decode's carry runs through every tile of the stream."""
    from repro_torch.core.fp_delta import fp_delta_encode, fp_delta_plan

    it = np.int32 if np.dtype(dtype).itemsize == 4 else np.int64
    base = np.array([40.7], dtype).view(it)[0]
    x = (base + np.cumsum(rng.integers(-3000, 3000, n))).astype(it).view(dtype)
    payload, _ = fp_delta_encode(x)
    plan = fp_delta_plan(payload, n, np.dtype(dtype))
    require(int(np.sum(plan.flags)) == 0, "anchor_free_plan: the page has escapes")
    return plan


def decode_cases(rng):
    """Adversarial streams for kernel 1 beyond the main and mixed-page ones,
    as (name, words32, tok_off, nbits, anchor, width): per width, a 4.2 M
    value page with one anchor (the look-back chains over about 2,000
    tiles), an all-anchor stream of raw pages, one stream block (half a
    tile), and 1,057 and 2,115 blocks (partial last tiles; 529 and 1,058
    tiles, which no grid of whole SMs divides) cut from a longer stream."""
    from repro_torch.core.fp_delta import fp_delta_encode, fp_delta_plan
    from repro_torch.core.pages import PageMeta, page_stream_plan
    from repro_torch.kernels.fp_delta import build_page_stream, stream_from_numpy

    out = []
    for dt in (np.float32, np.float64):
        wname = f"w{np.dtype(dt).itemsize * 8}"
        d = stream_from_numpy(build_page_stream([anchor_free_plan(rng, dt, 4_200_000)]),
                              device=DEVICE)
        out.append((f"long_carry_chain_{wname}", d.words32, d.tok_off, d.nbits, d.anchor, d.width))
        raw = rng.normal(-8.6, 1.0, 300_000).astype(dt)
        meta = PageMeta(0, raw.nbytes, len(raw), 0, 0, 0.0, 0.0, "raw", 0, 0)
        plan = page_stream_plan(raw.tobytes(), meta, np.dtype(dt), "none")
        d = stream_from_numpy(build_page_stream([plan, plan]), device=DEVICE)
        out.append((f"all_anchors_{wname}", d.words32, d.tok_off, d.nbits, d.anchor, d.width))
        plans = [fp_delta_plan(fp_delta_encode(p)[0], len(p), np.dtype(dt))
                 for p in adversarial_pages(rng, dt, 3000)]
        long = build_page_stream(plans + [anchor_free_plan(rng, dt, 2200 * 1024)])
        d = stream_from_numpy(long, device=DEVICE)
        for nb in (1, 1057, 2115):
            out.append((f"n_blocks_{nb}_{wname}", d.words32,
                        *(t[:nb].contiguous() for t in (d.tok_off, d.nbits, d.anchor)), d.width))
    return out


def mismatches(a, b) -> tuple[int, float]:
    """Positions whose bit patterns differ, and the largest |difference| of
    the patterns read as integers (0 when they agree)."""
    import torch

    a = a.reshape(-1)
    b = b.reshape(-1)
    if a.dtype.is_floating_point:
        a = a.view(torch.int32 if a.element_size() == 4 else torch.int64)
        b = b.view(torch.int32 if b.element_size() == 4 else torch.int64)
    diff = a != b
    n = int(diff.sum())
    err = float((a[diff].double() - b[diff].double()).abs().max()) if n else 0.0
    return n, err


def check_kernels(path: Path, main: dict) -> list[dict]:
    import torch

    from repro_torch.kernels.fp_delta import kernel as fk, ref as fr, stream_from_numpy
    from repro_torch.kernels.minmax import bbox_query_keys, keys64
    from repro_torch.kernels.minmax import kernel as mk, ref as mr

    oracle = main["_oracle"]
    rng = np.random.default_rng(7)
    stream, aux, dur, ebounds = rg0_stream(path, oracle)
    table = []

    # ---- kernel 1: page-stream decode
    ds = stream_from_numpy(stream, aux, device=DEVICE)
    cases = [("main", ds)]
    for dt in (np.float32, np.float64):
        s, a, _ = adversarial_stream(rng, dt)
        cases.append((f"adversarial_w{np.dtype(dt).itemsize * 8}",
                      stream_from_numpy(s, a, device=DEVICE)))
    checks = [(name, (d.words32, d.tok_off, d.nbits, d.anchor, d.width)) for name, d in cases]
    checks += [(name, tuple(args)) for name, *args in decode_cases(np.random.default_rng(17))]
    bad, err = 0, 0.0

    def held(name, args, got) -> None:
        nonlocal bad, err
        m, e = mismatches(got, fr.decode_stream_ref(*args))
        emit({"check": "fp_delta.decode_stream", "case": name, "positions": int(args[1].numel()),
              "width": args[4], "mismatches": m})
        bad, err = bad + m, max(err, e)

    for name, args in checks:
        got = fk.decode_stream(*args)
        torch.cuda.synchronize()
        held(name, args, got)
    # two calls queued back to back, then four threads at once (the scanner's
    # pattern), three rounds: each call zeroes its own tile statuses
    two = [checks[0][1], checks[3][1]]
    outs = [fk.decode_stream(*a) for a in two]
    torch.cuda.synchronize()
    for i, (a, got) in enumerate(zip(two, outs)):
        held(f"back_to_back_{i}", a, got)
    four = [checks[i][1] for i in (0, 1, 2, 3)]
    with ThreadPoolExecutor(max_workers=4) as pool:
        for r in range(3):
            outs = list(pool.map(lambda a: fk.decode_stream(*a), four))
            torch.cuda.synchronize()
            for i, (a, got) in enumerate(zip(four, outs)):
                held(f"four_threads_round{r}_{i}", a, got)
    args = (ds.words32, ds.tok_off, ds.nbits, ds.anchor, ds.width)
    n = ds.n_values
    # the packed words up to the end of the last token (the buffer's pow2 tail is not read)
    last_bit = int((stream.tok_off.reshape(-1)[:n].astype(np.int64)
                    + stream.nbits.reshape(-1)[:n]).max())
    words_used = -(-last_bit // 32) * 4
    k_ms = cuda_ms(lambda: fk.decode_stream(*args))
    k_dev = device_ms(lambda: fk.decode_stream(*args))
    p_ms = cuda_ms(lambda: fr.decode_stream_ref(*args), iters=3, warmup=1)
    bytes_moved = words_used + 12 * n + n * ds.width // 8
    table.append(dict(name="fp_delta.decode_stream", route="cuda",
                      source="src/repro_torch/csrc/fp_delta_decode.cu",
                      replaces="src/repro/kernels/fp_delta/kernel.py:159",
                      mismatches=bad, max_abs_err=err, ms=k_ms, device_ms=k_dev, plain_ms=p_ms,
                      bytes=bytes_moved, bound_ms=bytes_moved / HBM_BYTES_PER_S * 1e3,
                      bound_by="bytes", library_ms=None,
                      shape={"values": n, "positions": int(ds.tok_off.numel()),
                             "packed_word_bytes": words_used, "width": ds.width}))

    # ---- kernel 2: per-record min/max + bbox survivor test
    bbox = main["_boxes"]["refine_10pct"]
    rcases = []
    for name, d in cases:
        bits = fk.decode_stream(d.words32, d.tok_off, d.nbits, d.anchor, d.width)
        dt = np.float32 if d.width == 32 else np.float64
        q = keys64(bbox_query_keys(bbox if name == "main" else (-1.0, -2.0, 42.0, 41.5), dt))
        rcases.append((name, (bits, d.x_start, d.y_start, d.counts, d.valid, q, d.width)))
    bad, err = 0, 0.0
    for name, rargs in rcases:
        kk, km = mk.segminmax_refine(*rargs)
        pk, pm = mr.segminmax_refine_ref(*rargs)
        torch.cuda.synchronize()
        m1, e1 = mismatches(kk.to(torch.int32), pk.to(torch.int32))
        m2, e2 = mismatches(km, pm)
        emit({"check": "minmax.segminmax_refine", "case": name,
              "records": int(rargs[3].shape[0]), "kept": int(kk.sum()),
              "mismatches": m1 + m2})
        bad, err = bad + m1 + m2, max(err, e1, e2)
    rargs = rcases[0][1]
    n_rec = int(rargs[3].shape[0])
    k_ms = cuda_ms(lambda: mk.segminmax_refine(*rargs))
    k_dev = device_ms(lambda: mk.segminmax_refine(*rargs))
    p_ms = cuda_ms(lambda: mr.segminmax_refine_ref(*rargs), iters=3, warmup=1)
    vals = 2 * int(aux.counts.sum())
    bytes_moved = vals * ds.width // 8 + n_rec * (8 * 3 + 1) + n_rec * (1 + 32)
    table.append(dict(name="minmax.segminmax_refine", route="cuda",
                      source="src/repro_torch/csrc/segminmax_refine.cu",
                      replaces="src/repro/kernels/minmax/kernel.py:93",
                      mismatches=bad, max_abs_err=err, ms=k_ms, device_ms=k_dev, plain_ms=p_ms,
                      bytes=bytes_moved, bound_ms=bytes_moved / HBM_BYTES_PER_S * 1e3,
                      bound_by="bytes", library_ms=None,
                      shape={"records": n_rec, "values": vals, "width": ds.width}))

    # ---- kernel 3: per-page min/max of a float32 column
    pcases = [("main", dur, ebounds), ("adversarial", *adversarial_pages_minmax(rng))]
    pcases += minmax_page_cases(rng)
    bad, err = 0, 0.0
    held_pairs = []

    def held_pages(name, vt, bt, got) -> None:
        nonlocal bad, err
        pmn, pmx = mr.page_minmax_ref(vt, bt)
        m1, e1 = mismatches(got[0], pmn)
        m2, e2 = mismatches(got[1], pmx)
        emit({"check": "minmax.page_minmax", "case": name, "pages": int(bt.numel()) - 1,
              "values": int(vt.numel()), "mismatches": m1 + m2})
        bad, err = bad + m1 + m2, max(err, e1, e2)

    for name, v, b in pcases:
        bt = torch.from_numpy(b).to(DEVICE)
        # the values pointer 0, 4 and 12 bytes off a 16-byte boundary
        for off in (0,) if name == "main" else (0, 1, 3):
            buf = torch.empty(len(v) + off, dtype=torch.float32, device=DEVICE)
            buf[off:] = torch.from_numpy(np.ascontiguousarray(v))
            vt = buf[off:]
            got = mk.page_minmax(vt, bt)
            torch.cuda.synchronize()
            held_pages(f"{name}_off{off}" if name != "main" else name, vt, bt, got)
            if off == 0:
                held_pairs.append((name, vt, bt))
    # calls queued back to back, then four threads at once, three rounds
    outs = [mk.page_minmax(vt, bt) for _, vt, bt in held_pairs]
    torch.cuda.synchronize()
    for (name, vt, bt), got in zip(held_pairs, outs):
        held_pages(f"back_to_back_{name}", vt, bt, got)
    with ThreadPoolExecutor(max_workers=4) as pool:
        for r in range(3):
            outs = list(pool.map(lambda c: mk.page_minmax(c[1], c[2]), held_pairs))
            torch.cuda.synchronize()
            for (name, vt, bt), got in zip(held_pairs, outs):
                held_pages(f"four_threads_round{r}_{name}", vt, bt, got)
    vt, bt = held_pairs[0][1:]
    lengths = bt[1:] - bt[:-1]
    k_ms = cuda_ms(lambda: mk.page_minmax(vt, bt))
    k_dev = device_ms(lambda: mk.page_minmax(vt, bt))
    p_ms = cuda_ms(lambda: mr.page_minmax_ref(vt, bt))
    l_ms = cuda_ms(lambda: (torch.segment_reduce(vt, "min", lengths=lengths),
                            torch.segment_reduce(vt, "max", lengths=lengths)))
    n_pages = len(ebounds) - 1
    bytes_moved = 4 * len(dur) + 8 * (n_pages + 1) + 8 * n_pages
    table.append(dict(name="minmax.page_minmax", route="cuda",
                      source="src/repro_torch/csrc/page_minmax.cu",
                      replaces="src/repro/kernels/minmax/kernel.py:53",
                      mismatches=bad, max_abs_err=err, ms=k_ms, device_ms=k_dev, plain_ms=p_ms,
                      bytes=bytes_moved, bound_ms=bytes_moved / HBM_BYTES_PER_S * 1e3,
                      bound_by="bytes", library_ms=l_ms,
                      shape={"values": len(dur), "pages": n_pages}))
    return table


# ---------------------------------------------------------------- dataset path
def dataset_order(cols) -> np.ndarray:
    """Input record index of each record in dataset order: the writer sorts
    all records once by the Hilbert key of their bbox centres (stable) and
    splits that order into shards, concatenated in manifest order."""
    from repro_torch.core.sfc import sort_keys
    from repro_torch.core.writer import record_centroids

    cx, cy = record_centroids(cols)
    return np.argsort(sort_keys(cx, cy, "hilbert", 16), kind="stable")


class DatasetOracle(Oracle):
    """The file oracle in dataset order, plus the shard and page layout the
    writer produces (``np.array_split`` into shards; pages of whole records
    up to ``page_values`` values, a record larger than that alone), from
    which the expected ``ReadStats`` of a bbox scan follow."""

    def __init__(self, cols, npts, extra, order, n_shards: int, page_values: int):
        super().__init__(cols, npts, extra, order)
        sizes = [len(c) for c in np.array_split(np.arange(order.size), n_shards)]
        self.shard_starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        counts = npts[order]
        starts = []
        for s0, size in zip(self.shard_starts, sizes):
            ends = np.cumsum(counts[s0:s0 + size])   # value end of each record
            r = 0
            while r < size:
                base = ends[r - 1] if r else 0
                nxt = int(np.searchsorted(ends, base + page_values, side="right"))
                nxt = min(max(nxt, r + 1), size)
                starts.append(s0 + r)
                r = nxt
        self.page_starts = np.array(starts, np.int64)
        self.page_shard = np.searchsorted(self.shard_starts, self.page_starts, side="right") - 1
        self.dur = extra["duration_s"][order]

    def stats(self, bbox, rng_filter=None) -> dict:
        x0, y0, x1, y1 = bbox

        def hits(starts):
            red = lambda f, a: f.reduceat(a, starts)   # noqa: E731
            k = ((red(np.minimum, self.xmin) <= x1) & (red(np.maximum, self.xmax) >= x0)
                 & (red(np.minimum, self.ymin) <= y1) & (red(np.maximum, self.ymax) >= y0))
            if rng_filter is not None:
                _, lo, hi = rng_filter
                k &= (red(np.maximum, self.dur) >= lo) & (red(np.minimum, self.dur) <= hi)
            return k

        shard_hit = hits(self.shard_starts)
        pages = hits(self.page_starts) & shard_hit[self.page_shard]
        return {"shards_total": int(shard_hit.size), "shards_read": int(shard_hit.sum()),
                "pages_total": int(self.page_starts.size), "pages_read": int(pages.sum())}


def scan_split(tracer, wall_s: float) -> dict:
    """Seconds of one traced scan: its wall time, and the per-shard spans
    summed over the worker threads (so the split adds up to the summed shard
    time, not to the wall): host plan, H2D, device, D2H (as read_split)."""
    tot = {r["name"]: r["total_ms"] / 1e3 for r in tracer.summary()}
    h2d = tot.get("device.h2d", 0.0)
    dev = tot.get("device.decode_launch", 0.0) + tot.get("device.refine_launch", 0.0)
    d2h = tot.get("device.gather", 0.0)
    shards = tot.get("shard", 0.0)
    return {"wall_s": wall_s, "shard_thread_s": shards, "host_plan_thread_s": shards - h2d - dev - d2h,
            "h2d_thread_s": h2d, "device_thread_s": dev, "d2h_thread_s": d2h}


def dataset_path(data, root: Path, main: dict, counters) -> dict:
    """Phase 3a: the sharded dataset tier over the same Porto columns."""
    import torch

    from repro_torch import obs
    from repro_torch.core.filters import Range
    from repro_torch.dataset import SpatialDatasetScanner, write_dataset

    cols, npts, extra, schema = data
    oracle = DatasetOracle(cols, npts, extra, dataset_order(cols), DATASET_SHARDS, 131072)
    boxes = main["_boxes"]
    rng_filter = ("duration_s", 300.0, 900.0)

    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    manifest = write_dataset(root, columns=cols, extra=extra, n_shards=DATASET_SHARDS,
                             sort="hilbert", device=DEVICE)
    write_s = time.perf_counter() - t0
    require(manifest.extra_schema == schema, f"manifest extra schema {manifest.extra_schema}")
    require(manifest.n_shards == DATASET_SHARDS, f"{manifest.n_shards} shards written")
    scanner = SpatialDatasetScanner(root, max_workers=DATASET_WORKERS)
    b10 = boxes["refine_10pct"]
    plan = [(name, dict(bbox=b, refine=True), None) for name, b in boxes.items()]
    plan.append(("refine_10pct_filter", dict(bbox=b10, refine=True, filter=Range(*rng_filter)),
                 rng_filter))
    plan.append(("refine_10pct_keep_on_device", dict(bbox=b10, refine=True, keep_on_device=True),
                 None))
    scans = {}
    for name, kw, flt in plan:
        tracer = obs.enable()
        t0 = time.perf_counter()
        res = scanner.scan(device=DEVICE, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        obs.disable()
        if kw.get("keep_on_device"):
            require(res[0].x.bits.device.type == torch.device(DEVICE).type,
                    f"{name}: coordinates left the device")
        n = oracle.check(res, oracle.keep(kw["bbox"], flt), f"dataset {name}")
        st = res[2]
        want = oracle.stats(kw["bbox"], flt)
        got = {k: getattr(st, k) for k in want}
        require(got == want, f"dataset {name}: ReadStats {got}, oracle {want}")
        require(not st.failures, f"dataset {name}: failed shards {st.failures}")
        scans[name] = {**scan_split(tracer, wall), "records": n,
                       "selectivity": n / oracle.order.size, **got,
                       "bytes_read": st.bytes_read, "bytes_total": st.bytes_total}
    launches = {c.kname: c.launches for c in counters}
    for name in FILE_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the dataset path")
    return {"write_s": write_s, "shards": manifest.n_shards,
            "shard_records": [s.n_records for s in manifest.shards],
            "dataset_bytes": sum(s.file_bytes for s in manifest.shards),
            "scans": scans, "launches": launches, "_oracle": oracle}


# ---------------------------------------------------------------- serve path
def serve_path(oracle: DatasetOracle, root: Path, counters) -> dict:
    """Phase 3c: the multi-query bbox server over the Porto lake, with the
    reference serve benchmark's traffic (boxes cycling ``QUERY_FRACS``)."""
    import torch

    from repro_torch import obs
    from repro_torch.dataset import SpatialDatasetScanner
    from repro_torch.serve import SpatialQueryServer

    boxes = [selectivity_bbox(oracle, f) for f in QUERY_FRACS]
    wants = [oracle.expect(oracle.keep(b)) for b in boxes]
    stats_want = [oracle.stats(b) for b in boxes]
    scanner = SpatialDatasetScanner(root, max_workers=DATASET_WORKERS)
    stat_keys = tuple(stats_want[0])

    def check(qs, what):
        for i, q in qs:
            oracle.check_expected((q.geo, q.extras, q.stats), wants[i], f"{what} q{q.qid}")
            got = {k: getattr(q.stats, k) for k in stat_keys}
            require(got == stats_want[i], f"{what} q{q.qid}: ReadStats {got}, oracle {stats_want[i]}")

    def wave(srv, n, what):
        tracer = obs.enable()
        t0 = time.perf_counter()
        qs = [(i % len(boxes), srv.submit(boxes[i % len(boxes)])) for i in range(n)]
        srv.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        obs.disable()
        check(qs, what)
        tot = {r["name"]: r["total_ms"] / 1e3 for r in tracer.summary()}
        split = {k: tot.get(k, 0.0) for k in SERVE_SPANS}
        counts = {k: len(tracer.spans(k)) for k in ("device.refine_multi_launch",
                                                    "device.refine_cached")}
        m = srv.metrics()
        # two host parts of host_plan_s: whole-row-group reads with their
        # stream building (misses only), and each query's result assembly
        host = {"rg_read_s": tot.get("rg.read_full", 0.0), "finalize_s": tot.get("serve.query", 0.0)}
        return {"served_s": wall, "host_plan_s": wall - sum(split.values()), **host, **split,
                **{k: m[k] for k in ("queries", "waves", "rg_touches", "rg_decodes",
                                     "shared_decode_ratio", "cache_hits", "cache_misses",
                                     "cache_evictions", "cache_entries")},
                "latency_p50_s": m.get("latency_p50"), "latency_p99_s": m.get("latency_p99"),
                "span_counts": counts,
                "records_returned": sum(q.stats.records_returned for _, q in qs)}

    out = {"query_fracs": list(QUERY_FRACS), "boxes": boxes, "max_wave": SERVE_MAX_WAVE,
           "cache_rgs": SERVE_CACHE_RGS, "by_query_count": {}}
    total = dict.fromkeys((c.kname for c in counters), 0)
    for n in SERVE_COUNTS:
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        for c in counters:
            c.launches = 0
        srv = SpatialQueryServer(scanner, device=DEVICE, cache_rgs=SERVE_CACHE_RGS,
                                 max_wave=SERVE_MAX_WAVE)
        require(srv.device == DEVICE, f"the server runs on {srv.device!r}")
        row = wave(srv, n, f"serve {n}")
        launches = {c.kname: c.launches for c in counters}
        for name in FILE_KERNELS[:2]:
            require(launches[name] > 0, f"kernel {name} was not launched by the {n}-query wave")
        for name in total:
            total[name] += launches[name]
        row["launches"] = launches
        torch.cuda.synchronize()
        row["cache_device_bytes"] = torch.cuda.memory_allocated() - mem0
        if n == SERVE_COUNTS[-1]:
            # the same boxes again: every row group is a cache hit
            for c in counters:
                c.launches = 0
            hit = wave(srv, n, f"serve {n} (second wave)")
            require(hit["rg_decodes"] == row["rg_decodes"],
                    f"the second wave decoded {hit['rg_decodes'] - row['rg_decodes']} row groups")
            require(hit["span_counts"]["device.refine_multi_launch"] == 0
                    and hit["span_counts"]["device.refine_cached"] > 0,
                    f"the second wave's device spans: {hit['span_counts']}")
            launches = {c.kname: c.launches for c in counters}
            require(not any(launches.values()), f"the second wave launched {launches}")
            for name in total:
                total[name] += launches[name]
            row["second_wave"] = hit
        srv.invalidate()
        torch.cuda.synchronize()
        freed = torch.cuda.memory_allocated()
        require(freed == mem0, f"after invalidate() {freed - mem0} device bytes remain")
        srv.close()
        out["by_query_count"][str(n)] = row
        emit({"serve_wave": {"queries": n, **row}})
        del srv
    # the unshared baseline: each distinct box as a solo sequential scan
    t0 = time.perf_counter()
    for i, b in enumerate(boxes):
        res = scanner.scan(b, refine=True, device=DEVICE, parallel=False)
        torch.cuda.synchronize()
        oracle.check_expected(res, wants[i], f"sequential {QUERY_FRACS[i]}")
        del res
    out["sequential_s"] = time.perf_counter() - t0
    out["launches"] = total
    out["kernel_times"] = serve_shape_kernels(scanner, boxes[2])
    return out


def serve_shape_kernels(scanner, bbox) -> dict:
    """Kernels 1 and 2 timed at the shape the serve tier gives them: the
    first device chunk of a whole row group (shard 0, row group 0) read by
    ``read_row_group``, where the file path's launches cover a bbox's pages
    only. Each is held once against its plain version at this shape; these
    launches are not counted as the serve tier's."""
    import torch

    from repro_torch.kernels.fp_delta import kernel as fk, ref as fr, stream_from_numpy
    from repro_torch.kernels.minmax import bbox_query_keys, keys64
    from repro_torch.kernels.minmax import kernel as mk, ref as mr

    with scanner.open_shard(0) as r:
        data = r.read_row_group(0, device=DEVICE)
    ch = next((c for c in data.chunks if c.kind == "dev"), None)
    require(ch is not None, "shard 0 row group 0 has no device chunk")
    ds = stream_from_numpy(ch.stream, ch.aux, device=DEVICE)
    out = {}

    args = (ds.words32, ds.tok_off, ds.nbits, ds.anchor, ds.width)
    got = fk.decode_stream(*args)
    bad, err = mismatches(got, fr.decode_stream_ref(*args))
    n = ds.n_values
    last_bit = int((ch.stream.tok_off.reshape(-1)[:n].astype(np.int64)
                    + ch.stream.nbits.reshape(-1)[:n]).max())
    words_used = -(-last_bit // 32) * 4
    bytes_moved = words_used + 12 * n + n * ds.width // 8
    out["fp_delta.decode_stream"] = dict(
        mismatches=bad, max_abs_err=err, ms=cuda_ms(lambda: fk.decode_stream(*args)),
        device_ms=device_ms(lambda: fk.decode_stream(*args)), bytes=bytes_moved,
        bound_ms=bytes_moved / HBM_BYTES_PER_S * 1e3,
        shape={"values": n, "positions": int(ds.tok_off.numel()),
               "packed_word_bytes": words_used, "width": ds.width})

    q = keys64(bbox_query_keys(bbox, np.float32 if ds.width == 32 else np.float64))
    rargs = (got, ds.x_start, ds.y_start, ds.counts, ds.valid, q, ds.width)
    kk, km = mk.segminmax_refine(*rargs)
    pk, pm = mr.segminmax_refine_ref(*rargs)
    torch.cuda.synchronize()
    m1, e1 = mismatches(kk.to(torch.int32), pk.to(torch.int32))
    m2, e2 = mismatches(km, pm)
    n_rec = int(ds.counts.shape[0])
    vals = 2 * int(ch.aux.counts.sum())
    bytes_moved = vals * ds.width // 8 + n_rec * (8 * 3 + 1) + n_rec * (1 + 32)
    out["minmax.segminmax_refine"] = dict(
        mismatches=m1 + m2, max_abs_err=max(e1, e2),
        ms=cuda_ms(lambda: mk.segminmax_refine(*rargs)),
        device_ms=device_ms(lambda: mk.segminmax_refine(*rargs)), bytes=bytes_moved,
        bound_ms=bytes_moved / HBM_BYTES_PER_S * 1e3,
        shape={"records": n_rec, "values": vals, "width": ds.width})
    for name, row in out.items():
        require(row["mismatches"] == 0,
                f"{name}: kernel disagrees with its plain version at the serve shape")
    return out


# ---------------------------------------------------------------- data feed
def feed_path(root: Path, bbox, counters) -> dict:
    """Phase 3d: the trajectory data feed (the reference pipeline bench's
    settings) on the card and on the host; batches equal bit for bit."""
    from repro_torch.data.pipeline import Prefetcher, TrajectoryBatcher
    from repro_torch.data.synthetic import PORTO_BBOX
    from repro_torch.data.tokenizer import GeoTokenizer

    out, batches = {}, {}
    for device in (DEVICE, "host"):
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        it = Prefetcher(TrajectoryBatcher(
            [root], GeoTokenizer(PORTO_BBOX, order=6), seq_len=FEED_SEQ,
            global_batch=FEED_BATCH, bbox=bbox, loop=False, seed=0, device=device))
        batches[device] = [b["tokens"] for b in it]
        wall = time.perf_counter() - t0
        n_tok = sum(b.size for b in batches[device])
        out[device] = {"batches": len(batches[device]), "tokens": n_tok, "wall_s": wall,
                       "tokens_per_s": n_tok / wall, "stalls": it.stalls,
                       "launches": {c.kname: c.launches for c in counters}}
    got, want = batches[DEVICE], batches["host"]
    require(len(got) == len(want) > 0, f"{len(got)} batches on the card, {len(want)} on the host")
    require(all(np.array_equal(g, w) for g, w in zip(got, want)),
            "the card's batches differ from the host's")
    launches = out[DEVICE]["launches"]
    for name in FILE_KERNELS[:2]:
        require(launches[name] > 0, f"kernel {name} was not launched by the data feed")
    require(not any(out["host"]["launches"].values()), "the host feed launched a kernel")
    out["launches"] = launches
    return out


# ---------------------------------------------------------------- codec path
def codec_path(cols, counters) -> dict:
    """Phase 3b: ``compress_array``/``decompress_array`` of the Porto x and
    y columns as float32 (the reference bench's ``x32``) on the card."""
    import torch

    from repro_torch.core.fp_delta import fp_delta_encode
    from repro_torch.kernels.fp_delta import compress_array, decompress_array

    arrays = {"x32": cols.x.astype(np.float32), "y32": cols.y.astype(np.float32)}
    out = {}
    for c in counters:
        c.launches = 0
    for name, a in arrays.items():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        buf = compress_array(a, device=DEVICE)
        ev[1].record()
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ev[2].record()
        back = decompress_array(buf, a.shape, np.float32, device=DEVICE)
        ev[3].record()
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        require(back.dtype == np.float32 and back.shape == a.shape, f"codec {name}: {back.dtype} {back.shape}")
        require(np.array_equal(back.view(np.int32), a.view(np.int32)), f"codec {name}: bits differ")
        out[name] = {"values": int(a.size), "raw_bytes": int(a.nbytes), "compressed_bytes": len(buf),
                     "ratio": a.nbytes / len(buf), "compress_wall_s": enc_s,
                     "decompress_wall_s": dec_s, "compress_events_ms": ev[0].elapsed_time(ev[1]),
                     "decompress_events_ms": ev[2].elapsed_time(ev[3])}
    launches = {c.kname: c.launches for c in counters}
    for name in CODEC_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the codec path")
    for name, a in arrays.items():
        t0 = time.perf_counter()
        exact, _ = fp_delta_encode(a)
        mini = out[name]["compressed_bytes"] - 16        # FPD2 header: magic, n_values, n_blocks
        out[name].update(exact_bytes=len(exact), exact_encode_s=time.perf_counter() - t0,
                         miniblock_vs_exact_penalty_pct=100.0 * (mini / len(exact) - 1.0))
    return {"arrays": out, "launches": launches, "_x32": arrays["x32"]}


def codec_blocks(rng) -> list[tuple[str, np.ndarray, tuple | None]]:
    """Adversarial miniblocks as uint32 patterns (n, 1024), each with the
    (width, exception count) it must encode to, or None."""
    import torch

    from repro_torch.kernels.fp_delta.ops import _pad_to_blocks
    from repro_torch.kernels.fp_delta.ref import WIDTHS

    def from_zig(z):
        z = np.asarray(z, np.uint32).copy()
        z[0] = 0
        d = (z >> np.uint32(1)) ^ (np.uint32(0) - (z & np.uint32(1)))
        return np.uint32(0x42240000) + np.cumsum(d, dtype=np.uint32)

    def bits(lo, hi, n):
        return rng.integers(lo, hi, n, dtype=np.uint64).astype(np.uint32)

    cases = [("random_int32", rng.integers(0, 2 ** 32, (4, 1024), dtype=np.uint64)
              .astype(np.uint32), (32, 0)),
             ("constant", np.full((1, 1024), np.float32(2.5)).view(np.uint32), (0, 0))]
    for w in WIDTHS:
        cases.append((f"width_{w}", from_zig(bits(1 << (w - 1), 1 << w, 1024))[None], (w, 0)))
    for k, want in ((64, (4, 64)), (65, (20, 0))):
        z = bits(8, 16, 1024)
        z[rng.choice(np.arange(1, 1024), k, replace=False)] = bits(1 << 19, 1 << 20, k)
        cases.append((f"outliers_{k}", from_zig(z)[None], want))
    z = np.ones(1024, np.uint32)            # cost(1) = 1024 + 48*64 = cost(4): keeps 1
    z[rng.choice(np.arange(1, 1024), 64, replace=False)] = bits(8, 16, 64)
    cases.append(("cost_tie", from_zig(z)[None], (1, 64)))
    sp = (np.cumsum(rng.normal(0, 1e-4, 2048)) + 41.1).astype(np.float32).view(np.uint32)
    specials = np.array([0x7FC00001, 0xFFA00005, 0x7F800001, 0x7F800000, 0xFF800000, 0x0,
                         0x80000000, 0x1, 0x80000001, 0x007FFFFF], np.uint32)
    sp[rng.integers(0, sp.size, 40)] = specials[rng.integers(0, specials.size, 40)]
    cases.append(("nan_inf_zero_denormal", sp.reshape(2, 1024), None))
    ragged = (np.cumsum(rng.normal(0, 1e-3, 3 * 1024 + 333)) - 8.6).astype(np.float32)
    cases.append(("ragged_last_block",
                  _pad_to_blocks(torch.from_numpy(ragged))[0].numpy().view(np.uint32), None))
    return cases


def decode_malformed(enc, rng) -> list[tuple[str, list]]:
    """Decode inputs that encode never writes, cut from six encoded blocks
    ``enc``: repeated live exception slots (three on one position, a pair
    whose sum wraps, all 64 on one position), positions -1, 1024, 65535 and
    -2^31, exception counts -1, 0, 64 and 255 over random slots with ten
    repeats, and widths outside the format (5, 33, -1, 7, 255)."""
    import torch

    def i32(a):
        return torch.tensor(np.asarray(a, np.int64).astype(np.int32), device=DEVICE)

    def fresh():
        return [t[:6].clone() for t in enc]

    out = []
    a = fresh()
    a[3][0, :5] = i32([17, 17, 17, 900, 900])
    a[4][0, :5] = i32([5, 9, -2, 2 ** 31 - 1, 2 ** 31 - 1])
    a[5][0] = 5
    a[3][1, :] = 3
    a[4][1, :] = i32(rng.integers(-2 ** 31, 2 ** 31, 64))
    a[5][1] = 64
    out.append(("repeated_slots", a))
    a = fresh()
    a[3][2, :6] = i32([-1, 1024, 65535, 0, 1023, -2 ** 31])
    a[4][2, :6] = i32(rng.integers(-2 ** 31, 2 ** 31, 6))
    a[5][2] = 6
    out.append(("positions_out_of_range", a))
    for c in (-1, 0, 64, 255):
        a = fresh()
        a[3][:] = i32(rng.integers(0, 1024, (6, 64)))
        a[3][:, 10:20] = 500
        a[4][:] = i32(rng.integers(-2 ** 31, 2 ** 31, (6, 64)))
        a[5][:] = c
        out.append((f"count_{c}", a))
    a = fresh()
    a[1][:] = i32([5, 33, -1, 7, 255, 32])
    out.append(("widths_outside_format", a))
    return out


def check_codec(codec: dict) -> list[dict]:
    """Both codec kernels against their plain versions at the codec path's
    shape and on :func:`codec_blocks`; exact equality, then times."""
    import torch

    from repro_torch.kernels.fp_delta import kernel as fk, ref as fr
    from repro_torch.kernels.fp_delta.ops import _pad_to_blocks

    main_blocks = _pad_to_blocks(torch.from_numpy(codec["_x32"]).to(DEVICE))[0]
    cases = [("main_x32", main_blocks, None)]
    blocks = codec_blocks(np.random.default_rng(11))
    cases += [(n, torch.from_numpy(b.view(np.float32)).to(DEVICE), want) for n, b, want in blocks]
    # 1 and 7 miniblocks (fewer than the grid's warps) and 5,000 (more than
    # its warps hold at once), drawn from the adversarial blocks
    pool = np.concatenate([b for _, b, _ in blocks])
    pick = np.random.default_rng(12)
    cases += [(f"blocks_{k}", torch.from_numpy(pool[pick.integers(0, len(pool), k)]
                                               .view(np.float32)).to(DEVICE), None)
              for k in (1, 7, 5000)]
    bad_e = bad_d = 0
    err_e = err_d = 0.0
    for name, blocks, want in cases:
        ko = fk.encode_blocks(blocks)
        po = fr.encode_blocks_ref(blocks)
        kd = fk.decode_blocks(*ko)
        pd = fr.decode_blocks_ref(*ko)
        torch.cuda.synchronize()
        me_all = [mismatches(a, b) for a, b in zip(ko, po)]
        md_all = [mismatches(kd, pd), mismatches(kd, blocks)]
        me, md = sum(m for m, _ in me_all), sum(m for m, _ in md_all)
        err_e = max([err_e] + [e for _, e in me_all])
        err_d = max([err_d] + [e for _, e in md_all])
        line = {"check": "fp_delta.miniblock", "case": name, "blocks": int(blocks.shape[0]),
                "encode_mismatches": me, "decode_mismatches": md}
        if blocks.shape[0] <= 4:
            line["widths"] = ko[1].tolist()
            line["exc_count"] = ko[5].tolist()
        if want is not None:
            got = (int(ko[1][0]), int(ko[5][0]))
            require(got == want, f"miniblock {name}: (width, exceptions) {got}, designed {want}")
        emit(line)
        bad_e, bad_d = bad_e + me, bad_d + md
    n = int(main_blocks.shape[0])
    enc = fk.encode_blocks(main_blocks)
    # streams outside encode's contract: the kernel sums repeated live
    # slots as the plain version (and the reference) does
    for name, args in decode_malformed(enc, np.random.default_rng(13)):
        m, e = mismatches(fk.decode_blocks(*args), fr.decode_blocks_ref(*args))
        emit({"check": "fp_delta.decode_malformed", "case": name, "blocks": 6,
              "mismatches": m})
        bad_d, err_d = bad_d + m, max(err_d, e)
    widths, counts = enc[1].to(torch.int64), enc[5].to(torch.int64)
    e_ms = cuda_ms(lambda: fk.encode_blocks(main_blocks))
    e_dev = device_ms(lambda: fk.encode_blocks(main_blocks))
    ep_ms = cuda_ms(lambda: fr.encode_blocks_ref(main_blocks), iters=3, warmup=1)
    d_ms = cuda_ms(lambda: fk.decode_blocks(*enc))
    d_dev = device_ms(lambda: fk.decode_blocks(*enc))
    dp_ms = cuda_ms(lambda: fr.decode_blocks_ref(*enc), iters=3, warmup=1)
    # encode: 4 B a value in; packed words, three int32 scalars and 2 x 64 slots out
    e_bytes = n * (4096 + 4096 + 12 + 2 * 64 * 4)
    # decode: valid payload words, live exception slots and the scalars in; 4 B a value out
    d_bytes = int(widths.sum()) * 32 * 4 + int(counts.sum()) * 8 + n * 12 + n * 4096
    shape = {"blocks": n, "values": n * 1024, "mean_width": float(widths.double().mean()),
             "exceptions": int(counts.sum())}
    row = dict(route="cuda", source="src/repro_torch/csrc/miniblock.cu", library_ms=None,
               bound_by="bytes", shape=shape)
    return [dict(row, name=CODEC_KERNELS[0], replaces="src/repro/kernels/fp_delta/kernel.py:102",
                 mismatches=bad_e, max_abs_err=err_e, ms=e_ms, device_ms=e_dev,
                 plain_ms=ep_ms, bytes=e_bytes, bound_ms=e_bytes / HBM_BYTES_PER_S * 1e3),
            dict(row, name=CODEC_KERNELS[1], replaces="src/repro/kernels/fp_delta/kernel.py:233",
                 mismatches=bad_d, max_abs_err=err_d, ms=d_ms, device_ms=d_dev,
                 plain_ms=dp_ms, bytes=d_bytes, bound_ms=d_bytes / HBM_BYTES_PER_S * 1e3)]


# ---------------------------------------------------------------- LM path
def diff_stats(a, b, rows: int = 1024) -> dict:
    """Largest |a - b|, that over max |b|, and the share of positions whose
    argmax agree, over the last axis; in row chunks to bound the float32
    temporaries."""
    a2, b2 = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    mx = bmax = 0.0
    agree = 0
    for i in range(0, a2.shape[0], rows):
        x, y = a2[i:i + rows].float(), b2[i:i + rows].float()
        mx = max(mx, float((x - y).abs().max()))
        bmax = max(bmax, float(y.abs().max()))
        agree += int((x.argmax(-1) == y.argmax(-1)).sum())
    return {"max_abs": mx, "max_rel": mx / bmax, "top1_agree": agree / a2.shape[0]}


def tensors(tree) -> list:
    """The leaves of a nested dict of tensors."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors(v)]
    return [tree]


def device_split(fn) -> dict:
    """Device time of one call of ``fn`` by kernel group, from a
    ``torch.profiler`` trace: the flash kernel, cuBLAS matrix products, and
    everything else (casts, norms, RoPE, softmax, copies); and the share of
    the call's wall time in which some kernel ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    groups = {"flash_ms": 0.0, "gemm_ms": 0.0, "other_ms": 0.0}
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        name = e.name.lower()
        if "flash_fwd" in name:
            key = "flash_ms"
        elif any(t in name for t in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
            key = "gemm_ms"
        else:
            key = "other_ms"
        groups[key] += us / 1e3
        spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):          # union of the kernels' intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    require(spans, "the profiler saw no device activity")
    return {**groups, "kernels": len(spans), "wall_ms": wall_us / 1e3,
            "device_busy_share": busy / wall_us}


def lm_path(args, counters) -> dict:
    """qwen3-8b forward (flash) and batched serving; the checks of phase 4.

    Logit tolerance. bf16 rounds at other places on the flash and plain
    paths (the kernel rounds the unnormalised P of each key tile to bf16,
    the plain path the normalised P), and 36 layers carry those roundings
    to the logits. Both paths
    are therefore held against a float32 forward of the same weights and
    tokens, and the flash logits must lie within twice the plain path's own
    distance to it: max |flash - plain| <= 2 * max |plain - float32|. If
    the flash path is no less faithful to float32 than the plain one, this
    holds by the triangle inequality.

    First tokens. Each request's first token must equal the argmax of the
    plain ``forward`` over its prompt alone, or score within the plain
    path's measured bf16 noise (max |plain - float32|) of that argmax: the
    server prefills a right-padded wave of 4 slots, whose bf16 products are
    rounded in other orders than a batch of one.
    """
    import dataclasses

    import torch

    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import BatchedServer

    base = get_config(LM_CONFIG)
    model = build_model(dataclasses.replace(base, attn_impl="flash"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(args.seed, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tensors(params))
    param_bytes = sum(t.numel() * t.element_size() for t in tensors(params))
    rng = np.random.default_rng(args.seed + 2)
    tokens = rng.integers(0, base.vocab, (LM_BATCH, LM_SEQ)).astype(np.int32)
    model.forward(params, {"tokens": tokens[:1, :128]})   # cuBLAS handles, first launches
    torch.cuda.synchronize()

    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    flash, _, _ = model.forward(params, {"tokens": tokens})
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    fwd_launches = {c.kname: c.launches for c in counters}
    require(tuple(flash.shape) == (LM_BATCH, LM_SEQ, base.vocab)
            and flash.dtype == torch.bfloat16, f"forward gave {flash.dtype} {tuple(flash.shape)}")
    require(bool(torch.isfinite(flash).all()), "forward gave non-finite logits")
    require(fwd_launches[LM_KERNELS[0]] == base.n_layers,
            f"{fwd_launches[LM_KERNELS[0]]} flash launches in one forward, "
            f"expected {base.n_layers}")
    require(fwd_launches[F32_FLASH] == 0, "the bf16 forward reached the float32 flash kernel")

    def serve(n_req, max_batch, new_tokens):
        """Submit ``n_req`` prompts of 16-64 random tokens at once and run
        the server until it drains; check every answer."""
        lens = rng.integers(16, 65, n_req)
        prompts = [rng.integers(3, base.vocab, int(n)).astype(np.int32) for n in lens]
        srv = BatchedServer(model.cfg, params, max_batch=max_batch, max_len=SERVE_MAX_LEN)
        obs.enable()
        t0 = time.perf_counter()
        for i, p in enumerate(prompts):
            srv.submit(p, max_new_tokens=new_tokens, rid=i)
        done = srv.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        hists = obs.snapshot()["histograms"]
        obs.disable()
        require(sorted(r.rid for r in done) == list(range(n_req)),
                f"served rids {sorted(r.rid for r in done)}, expected 0..{n_req - 1}")
        require(all(1 <= len(r.out_tokens) <= new_tokens for r in done),
                f"token counts {sorted({len(r.out_tokens) for r in done})}")
        for h in ("serve.ttft_s", "serve.latency_s"):
            require(hists[h]["count"] == n_req, f"{h} holds {hists[h]['count']} observations")
        return srv, done, wall

    # the functional check: a few requests whose first tokens are checked below
    srv, done, _ = serve(SERVE_CHECK_REQUESTS, 4, 16)
    launches = {c.kname: c.launches for c in counters}
    for name in LM_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the LM path")
    del srv
    # the load: enough requests and batch for latency percentiles to mean something
    srv, load_done, load_s = serve(*SERVE_LOAD)
    n_tok = sum(len(r.out_tokens) for r in load_done)
    ttft = np.array([r.t_first - r.t_submit for r in load_done])
    lat = np.array([r.t_done - r.t_submit for r in load_done])
    qs = {"p50": 50, "p90": 90, "p99": 99}
    load = {"requests": len(load_done), "max_batch": SERVE_LOAD[1],
            "max_new_tokens": SERVE_LOAD[2], "new_tokens": n_tok, "wall_s": load_s,
            "tokens_per_s": n_tok / load_s,
            "ttft_s": {k: float(np.percentile(ttft, q)) for k, q in qs.items()},
            "latency_s": {k: float(np.percentile(lat, q)) for k, q in qs.items()}}
    peak_path = torch.cuda.max_memory_allocated()
    split = {"forward": device_split(lambda: model.forward(params, {"tokens": tokens}))}
    srv.submit(load_done[0].prompt, max_new_tokens=3, rid=SERVE_LOAD[0])
    srv._fill_slots()
    split["decode_step"] = device_split(srv._decode_once)
    del srv
    emit({"lm_device_split": split})

    plain_model = build_model(dataclasses.replace(base, attn_impl="ref"))
    t0 = time.perf_counter()
    plain, _, _ = plain_model.forward(params, {"tokens": tokens})
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    torch.backends.cuda.matmul.allow_tf32 = False
    f32_model = build_model(dataclasses.replace(base, attn_impl="ref", dtype="float32"))
    t0 = time.perf_counter()
    full, _, _ = f32_model.forward(params, {"tokens": tokens})
    torch.cuda.synchronize()
    f32_s = time.perf_counter() - t0
    flash_plain = diff_stats(flash, plain)
    plain_f32 = diff_stats(plain, full)
    flash_f32 = diff_stats(flash, full)
    tol = 2 * plain_f32["max_abs"]
    emit({"lm_logits": {"flash_vs_plain": flash_plain, "plain_vs_float32": plain_f32,
                        "flash_vs_float32": flash_f32, "tolerance_max_abs": tol,
                        "tolerance_rel": tol / float(plain.float().abs().max())}})
    require(flash_plain["max_abs"] <= tol,
            f"flash logits differ from the plain path by {flash_plain['max_abs']} > {tol}")
    del flash, plain

    # the float32 route: the same forward in float32 compute with the flash
    # kernel, every count set to 0 just before; it launches the CUDA-core
    # kernel once a layer and must lie no farther from the float32 plain
    # forward than the bf16 plain forward does
    f32_flash_model = build_model(dataclasses.replace(base, attn_impl="flash", dtype="float32"))
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    f32_flash, _, _ = f32_flash_model.forward(params, {"tokens": tokens})
    torch.cuda.synchronize()
    f32_flash_s = time.perf_counter() - t0
    f32_launches = {c.kname: c.launches for c in counters}
    require(f32_launches[F32_FLASH] == base.n_layers and f32_launches[LM_KERNELS[0]] == 0,
            f"the float32 forward launched {f32_launches[F32_FLASH]} float32 and "
            f"{f32_launches[LM_KERNELS[0]]} bf16 flash kernels, expected {base.n_layers} and 0")
    require(f32_flash.dtype == torch.float32 and bool(torch.isfinite(f32_flash).all()),
            f"the float32 flash forward gave {f32_flash.dtype} or non-finite logits")
    f32_route = {"forward_s": f32_flash_s, "launches": f32_launches,
                 "vs_float32_plain": diff_stats(f32_flash, full),
                 "tolerance_max_abs": plain_f32["max_abs"]}
    emit({"lm_float32_route": f32_route})
    require(f32_route["vs_float32_plain"]["max_abs"] <= plain_f32["max_abs"],
            f"float32 flash logits differ from the float32 plain forward by "
            f"{f32_route['vs_float32_plain']['max_abs']} > {plain_f32['max_abs']}")
    del f32_flash, full

    noise = plain_f32["max_abs"]
    exact, worst = 0, 0.0
    for r in sorted(done, key=lambda r: r.rid):
        lg, _, _ = plain_model.forward(params, {"tokens": r.prompt[None]})
        last = lg[0, -1].float()
        tok = r.out_tokens[0]
        gap = float(last.max() - last[tok])
        exact += int(int(last.argmax()) == tok)
        worst = max(worst, gap)
        require(gap <= noise, f"request {r.rid}: first token {tok} scores {gap} below the "
                              f"forward's argmax, beyond the bf16 noise {noise}")
    first = {"exact": exact, "of": len(done), "largest_gap": worst, "allowed_gap": noise}
    peak = torch.cuda.max_memory_allocated()
    del params, model, plain_model, f32_model, f32_flash_model
    torch.cuda.empty_cache()
    return {"config": LM_CONFIG, "n_params": n_params, "param_bytes": param_bytes,
            "init_s": init_s, "forward_s": forward_s, "forward_tokens": LM_BATCH * LM_SEQ,
            "plain_forward_s": plain_s, "float32_forward_s": f32_s, "float32_route": f32_route,
            "forward_launches": fwd_launches, "launches": launches, "device_split": split,
            "serve_check": {"requests": len(done),
                            "prompt_lens": [len(r.prompt) for r in
                                            sorted(done, key=lambda r: r.rid)],
                            "new_tokens": sum(len(r.out_tokens) for r in done),
                            "first_token": first},
            "serve_load": load,
            "max_memory_allocated_path": peak_path, "max_memory_allocated": peak}


FLASH_SHAPES = [  # tests/test_kernels.py of the reference: (b, hq, hkv, sq, sk, d, causal)
    (2, 4, 4, 128, 128, 64, True),
    (1, 8, 2, 256, 256, 64, True),
    (2, 2, 2, 128, 128, 32, False),
    (1, 4, 4, 128, 384, 64, True),
    (1, 2, 2, 1, 128, 64, True),
    (1, 2, 2, 100, 128, 64, True),
]


def check_flash(seed: int) -> list[dict]:
    """Phase 5: both flash kernels against their plain version through
    ``ops.attention``, and their times at the LM path's shape.

    Tolerances. Every element of a kernel's output is held to the float32
    plain version on the same input values. bf16 (the sm90 kernel) rounds
    P to bf16 before P.V, which moves each term by at most u = 2^-8 of
    itself, and rounds its output once, so
    |got - want32| <= 2^-8 |want32| + (2^-8 + 2^-15) A + 1e-5 with A the
    plain version's softmax-weighted mean of |v| (2^-15 A: second-order
    terms; 1e-5: float32 sum order). The reference's 3e-2 against the bf16
    plain version (which also rounds P) is checked too, as its parity
    number. float32 (the CUDA-core kernel): 1e-5 at the LM shape, the
    reference's 2e-5 at its six shapes.
    """
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import attention, attention_plain, kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(seed + 3)
    cfg = get_config(LM_CONFIG)
    main_shape = (LM_BATCH, cfg.n_heads, cfg.n_kv_heads, LM_SEQ, LM_SEQ,
                  cfg.resolved_head_dim, True)

    def qkv(b, hq, hkv, sq, sk, d, dtype):
        # (B, S, H, D) as the model holds them, handed over as (B, H, S, D) views
        def one(h, s):
            a = torch.from_numpy(rng.normal(0, 1, (b, s, h, d)).astype(np.float32))
            return a.to(DEVICE, dtype).transpose(1, 2)
        return one(hq, sq), one(hkv, sk), one(hkv, sk)

    def name(sh, dt):
        return f"{dt}_{'x'.join(map(str, sh[:6]))}{'' if sh[6] else '_noncausal'}"

    cases = [("main_bf16", main_shape, torch.bfloat16), ("main_f32", main_shape, torch.float32)]
    cases += [(name(sh, dt), sh, dtype) for dt, dtype in (("bf16", torch.bfloat16),
                                                         ("f32", torch.float32))
              for sh in FLASH_SHAPES]
    bad = {torch.bfloat16: 0, torch.float32: 0}
    err = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for case, (b, hq, hkv, sq, sk, d, causal), dt in cases:
        q, k, v = qkv(b, hq, hkv, sq, sk, d, dt)
        got = attention(q, k, v, causal=causal).float()
        want = attention_plain(q.float(), k.float(), v.float(), causal=causal)
        diff = (got - want).abs()
        if dt == torch.bfloat16:
            a = attention_plain(q.float(), k.float(), v.float().abs(), causal=causal)
            tol = 2.0 ** -8 * want.abs() + (2.0 ** -8 + 2.0 ** -15) * a + 1e-5
            rule = "2^-8 |want32| + (2^-8 + 2^-15) A + 1e-5"
            del a
        else:
            tol = torch.full_like(want, 1e-5 if case == "main_f32" else 2e-5)
            rule = "1e-5" if case == "main_f32" else "2e-5"
        e = float(diff.max())
        share = float((diff / tol).max())
        line = {"check": "flash_attention", "case": case, "dtype": str(dt).split(".")[-1],
                "shape": [b, hq, hkv, sq, sk, d], "causal": causal, "max_abs_err": e,
                "tolerance": rule, "largest_share_of_tol": share}
        ok = share <= 1.0
        if dt == torch.bfloat16:
            pe = float((got - attention_plain(q, k, v, causal=causal).float()).abs().max())
            line["vs_bf16_plain"] = {"max_abs_err": pe, "tolerance": 3e-2}
            ok = ok and pe <= 3e-2
        emit(line)
        bad[dt] += int(not ok)
        err[dt] = max(err[dt], e)
        if case == "main_bf16":
            main = (q, k, v)
        del got, want, diff, tol
    q, k, v = main
    q32, k32, v32 = (t.float() for t in main)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_err = float((sdpa(q, k, v, is_causal=True, enable_gqa=True).float()
                     - attention_plain(q, k, v).float()).abs().max())
    # turns: sm90, SDPA, sm90 again
    k_ms = cuda_ms(lambda: kernel.flash_attention_sm90(q, k, v, causal=True), iters=20)
    l_ms = cuda_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), iters=20)
    k_ms2 = cuda_ms(lambda: kernel.flash_attention_sm90(q, k, v, causal=True), iters=20)
    k_dev = device_ms(lambda: kernel.flash_attention_sm90(q, k, v, causal=True))
    f32_ms = cuda_ms(lambda: kernel.flash_attention_f32(q32, k32, v32, causal=True), iters=5,
                     warmup=1)
    f32_dev = device_ms(lambda: kernel.flash_attention_f32(q32, k32, v32, causal=True), iters=5,
                        warmup=1)
    f32_lib_ms = cuda_ms(lambda: sdpa(q32, k32, v32, is_causal=True, enable_gqa=True), iters=5,
                         warmup=1)
    p_ms = cuda_ms(lambda: attention_plain(q, k, v), iters=3, warmup=1)
    f32_p_ms = cuda_ms(lambda: attention_plain(q32, k32, v32), iters=3, warmup=1)
    b, hq, hkv, sq, sk, d, _ = main_shape
    pairs = sq * (sq + 1) // 2                 # visible (row, col) pairs per head, Sq = Sk
    flops = 2 * 2 * d * pairs * b * hq         # QK^T and P.V, a multiply and an add each
    bytes_moved = 2 * (2 * q.numel() + k.numel() + v.numel())   # bf16 q, k, v read; o written
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, bytes_moved / HBM_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    # the float32 kernel: the same work on CUDA cores, float32 operands
    f32_ops, f32_bytes = flops / FP32_FLOPS_PER_S, 2 * bytes_moved / HBM_BYTES_PER_S
    emit({"flash_attention_times_ms": {
        "sm90_bf16": [k_ms, k_ms2], "cuda_cores_float32": f32_ms, "sdpa_bf16": l_ms,
        "sdpa_float32": f32_lib_ms, "plain_bf16": p_ms, "plain_float32": f32_p_ms,
        "bound": bound_ms, "shape": list(main_shape)}})
    require(bad[torch.float32] == 0, "the float32 flash kernel disagrees with its plain version")
    row = dict(route="cuda", replaces="src/repro/kernels/flash_attention/kernel.py:82", flops=flops)
    shape = {"b": b, "hq": hq, "hkv": hkv, "s": sq, "d": d}
    return [dict(row, name=LM_KERNELS[0], source="src/repro_torch/csrc/flash_attention_sm90.cu",
                 mismatches=bad[torch.bfloat16], max_abs_err=err[torch.bfloat16],
                 ms=min(k_ms, k_ms2), device_ms=k_dev, plain_ms=p_ms, bytes=bytes_moved,
                 bound_ms=bound_ms, bound_by="operations" if t_ops >= t_bytes else "bytes",
                 library_ms=l_ms, library_max_abs_err=lib_err,
                 tflops=flops / min(k_ms, k_ms2) / 1e9, shape=dict(shape, dtype="bfloat16")),
            dict(row, name=F32_FLASH, source="src/repro_torch/csrc/flash_attention.cu",
                 mismatches=bad[torch.float32], max_abs_err=err[torch.float32], ms=f32_ms,
                 device_ms=f32_dev, plain_ms=f32_p_ms, bytes=2 * bytes_moved,
                 bound_ms=max(f32_ops, f32_bytes) * 1e3,
                 bound_by="operations" if f32_ops >= f32_bytes else "bytes",
                 library_ms=f32_lib_ms, tflops=flops / f32_ms / 1e9,
                 shape=dict(shape, dtype="float32"))]


# ---------------------------------------------------------------- entry
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-traj", type=int, default=FULL_N_TRAJ,
                    help="trips to generate (default: the published 1,710,670)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside the script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as ak
    from repro_torch.kernels.fp_delta import kernel as fk
    from repro_torch.kernels.minmax import kernel as mk

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    emit({"gpu": gpu})
    t_start = time.perf_counter()
    _build.build_all(KERNEL_LIBS)
    emit({"build_s": time.perf_counter() - t_start})
    for lib in ("flash_attention_sm90", "fp_delta_decode", "miniblock", "page_minmax"):
        ptxas = [ln.strip() for ln in _build.logs.get(lib, "").splitlines()
                 if any(w in ln for w in ("entry function", "spill", "Used", "arning"))]
        if ptxas:
            emit({f"ptxas_{lib}": ptxas})
    counters = [fk.decode_stream, mk.segminmax_refine, mk.page_minmax, fk.encode_blocks,
                fk.decode_blocks, ak.flash_attention_sm90, ak.flash_attention_f32]
    names = list(FILE_KERNELS + CODEC_KERNELS + LM_KERNELS) + [F32_FLASH]
    for c, name in zip(counters, names):
        c.kname = name
    emit({"kernel_names": names})
    reduced = {"lm": {"config": LM_CONFIG, "shape": "train_4k", "seq_len": LM_SEQ,
                      "global_batch": [LM_FULL_BATCH, LM_BATCH]},
               "serve": {"query_counts": [[1, 16, 256], list(SERVE_COUNTS)],
                         "sequential_queries": [SERVE_COUNTS[-1], len(QUERY_FRACS)]}}
    if args.n_traj != FULL_N_TRAJ:
        reduced["n_traj"] = [FULL_N_TRAJ, args.n_traj]
    emit({"reduced": reduced})

    (ROOT / "build").mkdir(exist_ok=True)
    t0 = time.perf_counter()
    data = make_data(args.n_traj, args.seed)
    emit({"gen_s": time.perf_counter() - t0})
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = Path(tmp) / "porto_taxi.spqf"
        main = main_path(data, path, counters)
        emit({"main_path": {k: v for k, v in main.items() if not k.startswith("_")}})
        table = check_kernels(path, main)
        t0 = time.perf_counter()
        lake = Path(tmp) / "porto_lake"
        ds = dataset_path(data, lake, main, counters)
        ds["wall_s"] = time.perf_counter() - t0
        emit({"dataset_path": {k: v for k, v in ds.items() if not k.startswith("_")}})
        t0 = time.perf_counter()
        serve = serve_path(ds["_oracle"], lake, counters)
        serve["wall_s"] = time.perf_counter() - t0
        emit({"serve_path": {k: v for k, v in serve.items() if k != "by_query_count"}})
        t0 = time.perf_counter()
        feed = feed_path(lake, main["_boxes"]["refine_10pct"], counters)
        feed["wall_s"] = time.perf_counter() - t0
        emit({"feed_path": feed})
        del ds
    t0 = time.perf_counter()
    codec = codec_path(data[0], counters)
    codec["wall_s"] = time.perf_counter() - t0
    emit({"codec_path": {k: v for k, v in codec.items() if not k.startswith("_")}})
    table += check_codec(codec)
    codec_launches = codec["launches"]
    del data, codec
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lm = lm_path(args, counters)
    lm["wall_s"] = time.perf_counter() - t0
    emit({"lm_path": lm})
    table += check_flash(args.seed)
    launches = {**{n: main["launches"][n] for n in FILE_KERNELS},
                **{n: codec_launches[n] for n in CODEC_KERNELS},
                **{n: lm["launches"][n] for n in LM_KERNELS},
                F32_FLASH: lm["float32_route"]["launches"][F32_FLASH]}
    launches_serve = {n: serve["launches"][n] for n in launches}
    serve_shape = serve["kernel_times"]
    launches_feed = {n: feed["launches"][n] for n in launches}
    for row in table:
        emit({"kernel": row["name"], "mismatches": row["mismatches"],
              "kernel_ms": row["ms"], "device_ms": row["device_ms"], "plain_ms": row["plain_ms"],
              "library_ms": row["library_ms"], "launches": launches[row["name"]],
              "launches_serve": launches_serve[row["name"]],
              "launches_feed": launches_feed[row["name"]],
              "shape": row["shape"], "bytes": row["bytes"],
              **({"serve_shape": serve_shape[row["name"]]}
                 if row["name"] in serve_shape else {})})
    for row in table:
        require(row["mismatches"] == 0, f"{row['name']}: kernel disagrees with its plain version")
    flash = next(r for r in table if r["name"] == LM_KERNELS[0])
    emit({"flash_attention_rate": {"tflops": flash["tflops"],
                                   "share_of_bound": flash["bound_ms"] / flash["ms"],
                                   "sdpa_max_abs_err_vs_plain": flash["library_max_abs_err"]}})
    emit({"total_s": time.perf_counter() - t_start})
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{**{k: (launches[r["name"]] if k == "launches" else r[k]) for k in keys},
                       "launches_serve": launches_serve[r["name"]],
                       "launches_feed": launches_feed[r["name"]],
                       **({"serve_shape": {k: serve_shape[r["name"]][k]
                                           for k in ("ms", "device_ms", "bound_ms")}}
                          if r["name"] in serve_shape else {})} for r in table]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
