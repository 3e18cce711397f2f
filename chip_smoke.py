#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on an NVIDIA GPU and hold it to account.

Usage (from the repository root, on a machine with one CUDA card)::

    python3 chip_smoke.py                 # full size: 1,710,670 Porto taxi trips
    python3 chip_smoke.py --n-traj 20000  # a cut, printed as {"reduced": ...}

Phases, each fatal on failure (nothing is caught):

1. the card's name and power limit; build every CUDA kernel from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, all started together);
2. the main path, with every kernel's launch count set to 0 just before:
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
   escapes, raw pages, NaN, ±inf, ±0, denormals, NaN and all-NaN pages);
   the tolerance is exact equality of bit patterns. Times come from CUDA
   events after warm-up.

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
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FULL_N_TRAJ = 1_710_670          # ECML/PKDD 2015 taxi-trajectory challenge trips
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (NVIDIA data sheet)
KERNEL_LIBS = ("fp_delta_decode", "segminmax_refine", "page_minmax")
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

    def check(self, res, keep, what: str) -> int:
        geo, extras, stats = res
        sel = self.order[keep]
        n = int(keep.sum())
        require(stats.records_returned == n,
                f"{what}: {stats.records_returned} records returned, oracle {n}")
        geo = geo.coords_to_host()
        iv = ragged(self.starts[sel], self.npts[sel])
        require(np.array_equal(ibits(geo.x), ibits(self.x[iv])), f"{what}: x bits differ")
        require(np.array_equal(ibits(geo.y), ibits(self.y[iv])), f"{what}: y bits differ")
        for k, v in self.extra.items():
            require(np.array_equal(ibits(np.ascontiguousarray(extras[k])),
                                   ibits(np.ascontiguousarray(v[sel]))),
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
def main_path(args, path: Path, counters) -> dict:
    import torch

    from repro_torch import obs
    from repro_torch.core.filters import Range
    from repro_torch.core.reader import SpatialParquetReader
    from repro_torch.core.writer import write_file

    t0 = time.perf_counter()
    cols, npts, extra, schema = make_data(args.n_traj, args.seed)
    gen_s = time.perf_counter() - t0
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
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the main path")
    return {"gen_s": gen_s, "write_s": write_s, "file_bytes": path.stat().st_size,
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
    bad, err = 0, 0.0
    for name, d in cases:
        args = (d.words32, d.tok_off, d.nbits, d.anchor, d.width)
        got, want = fk.decode_stream(*args), fr.decode_stream_ref(*args)
        torch.cuda.synchronize()
        m, e = mismatches(got, want)
        emit({"check": "fp_delta.decode_stream", "case": name, "values": d.n_values,
              "width": d.width, "mismatches": m})
        bad, err = bad + m, max(err, e)
    args = (ds.words32, ds.tok_off, ds.nbits, ds.anchor, ds.width)
    n = ds.n_values
    # the packed words up to the end of the last token (the buffer's pow2 tail is not read)
    last_bit = int((stream.tok_off.reshape(-1)[:n].astype(np.int64)
                    + stream.nbits.reshape(-1)[:n]).max())
    words_used = -(-last_bit // 32) * 4
    k_ms = cuda_ms(lambda: fk.decode_stream(*args))
    p_ms = cuda_ms(lambda: fr.decode_stream_ref(*args), iters=3, warmup=1)
    bytes_moved = words_used + 12 * n + n * ds.width // 8
    table.append(dict(name="fp_delta.decode_stream", route="cuda",
                      source="src/repro_torch/csrc/fp_delta_decode.cu",
                      replaces="src/repro/kernels/fp_delta/kernel.py:159",
                      mismatches=bad, max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                      bytes=bytes_moved, bound_ms=bytes_moved / HBM_BYTES_PER_S * 1e3,
                      bound_by="bytes", library_ms=None, shape={"values": n, "width": ds.width}))

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
    p_ms = cuda_ms(lambda: mr.segminmax_refine_ref(*rargs), iters=3, warmup=1)
    vals = 2 * int(aux.counts.sum())
    bytes_moved = vals * ds.width // 8 + n_rec * (8 * 3 + 1) + n_rec * (1 + 32)
    table.append(dict(name="minmax.segminmax_refine", route="cuda",
                      source="src/repro_torch/csrc/segminmax_refine.cu",
                      replaces="src/repro/kernels/minmax/kernel.py:93",
                      mismatches=bad, max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                      bytes=bytes_moved, bound_ms=bytes_moved / HBM_BYTES_PER_S * 1e3,
                      bound_by="bytes", library_ms=None,
                      shape={"records": n_rec, "values": vals, "width": ds.width}))

    # ---- kernel 3: per-page min/max of a float32 column
    pcases = [("main", dur, ebounds), ("adversarial", *adversarial_pages_minmax(rng))]
    bad, err = 0, 0.0
    tensors = []
    for name, v, b in pcases:
        vt = torch.from_numpy(np.ascontiguousarray(v)).to(DEVICE)
        bt = torch.from_numpy(b).to(DEVICE)
        tensors.append((vt, bt))
        kmn, kmx = mk.page_minmax(vt, bt)
        pmn, pmx = mr.page_minmax_ref(vt, bt)
        torch.cuda.synchronize()
        m1, e1 = mismatches(kmn, pmn)
        m2, e2 = mismatches(kmx, pmx)
        emit({"check": "minmax.page_minmax", "case": name, "pages": len(b) - 1,
              "values": len(v), "mismatches": m1 + m2})
        bad, err = bad + m1 + m2, max(err, e1, e2)
    vt, bt = tensors[0]
    lengths = bt[1:] - bt[:-1]
    k_ms = cuda_ms(lambda: mk.page_minmax(vt, bt))
    p_ms = cuda_ms(lambda: mr.page_minmax_ref(vt, bt))
    l_ms = cuda_ms(lambda: (torch.segment_reduce(vt, "min", lengths=lengths),
                            torch.segment_reduce(vt, "max", lengths=lengths)))
    n_pages = len(ebounds) - 1
    bytes_moved = 4 * len(dur) + 8 * (n_pages + 1) + 8 * n_pages
    table.append(dict(name="minmax.page_minmax", route="cuda",
                      source="src/repro_torch/csrc/page_minmax.cu",
                      replaces="src/repro/kernels/minmax/kernel.py:53",
                      mismatches=bad, max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                      bytes=bytes_moved, bound_ms=bytes_moved / HBM_BYTES_PER_S * 1e3,
                      bound_by="bytes", library_ms=l_ms,
                      shape={"values": len(dur), "pages": n_pages}))
    return table


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
    from repro_torch.kernels.fp_delta import kernel as fk
    from repro_torch.kernels.minmax import kernel as mk

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    emit({"gpu": gpu})
    t0 = time.perf_counter()
    _build.build_all(KERNEL_LIBS)
    emit({"build_s": time.perf_counter() - t0})
    counters = [fk.decode_stream, mk.segminmax_refine, mk.page_minmax]
    names = ["fp_delta.decode_stream", "minmax.segminmax_refine", "minmax.page_minmax"]
    for c, name in zip(counters, names):
        c.kname = name
    emit({"kernel_names": names})
    if args.n_traj != FULL_N_TRAJ:
        emit({"reduced": {"n_traj": [FULL_N_TRAJ, args.n_traj]}})

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = Path(tmp) / "porto_taxi.spqf"
        main = main_path(args, path, counters)
        emit({"main_path": {k: v for k, v in main.items() if not k.startswith("_")}})
        table = check_kernels(path, main)
    for row in table:
        emit({"kernel": row["name"], "mismatches": row["mismatches"],
              "kernel_ms": row["ms"], "plain_ms": row["plain_ms"],
              "library_ms": row["library_ms"], "launches": main["launches"][row["name"]],
              "shape": row["shape"], "bytes": row["bytes"]})
    for row in table:
        require(row["mismatches"] == 0, f"{row['name']}: kernel disagrees with its plain version")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: (main["launches"][r["name"]] if k == "launches" else r[k])
                       for k in keys} for r in table]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
