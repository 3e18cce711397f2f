"""One run of one cell: set-up, the measured window, the check, the metrics.

Set-up (``setup_s``, from the process start to the window): build or load
the read path's kernels, generate the configuration's data from the seed
(the reference's generator), shred it with the port's ``from_ragged``, write
it with the port's ``write_file`` under ``TMPDIR`` (timed alone:
``write_mpts_per_s``), let the reference work out the file order, the
pages and the records' bboxes, draw the mix's queries, and run one warm-up
query. The reference's work and the drawing are timed apart and left out
of ``setup_s``. The window is the mix's driver (``spbench/drivers/``)
running its loop over the queries until ``seconds`` have passed.
Afterwards every answer is held against what the driver's reference
expects (:mod:`spbench.check`) and each metric of the cell is read by its
reader in ``spbench/metrics/``.

``--trace 1`` turns the program's obs spans on and runs ``torch.profiler``
over the window; the per-layer metrics read them. ``--trace 0`` measures
with both off.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import os
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from spbench import check, devtrace
from spbench.reference.oracle import Answer, Oracle
from spbench.reference.ragged import Ragged, bits
from spbench.traffic import QueryLog, load_part

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level names, compared whole
# the libraries the write and the bbox read launch (built before the write,
# so that no nvcc run falls inside it)
KERNEL_LIBS = ("fp_delta_decode", "segminmax_refine", "page_minmax")


# ---------------------------------------------------------------- the cell
@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    end_to_end: list[dict]
    per_layer: list[dict]
    queries: object          # spbench/queries/<mix's "queries">.py
    driver: object           # spbench/drivers/<mix's "driver">.py


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT, bench: dict | None = None) -> Cell:
    """The cell named ``workload``: its configuration, its mix, and the mix's
    query generator and driver, each found by name."""
    if bench is None:
        bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    confs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / confs[w["config"]]["file"]).read_text())
    mix = json.loads((root / "spbench" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(workload, config, mix, int(w["chips"]),
                [m for m in bench["end_to_end"] if _applies(m, workload)],
                [m for m in bench["per_layer"] if _applies(m, workload)],
                load_part("queries", mix["queries"], root), load_part("drivers", mix["driver"], root))


def load_reader(name: str):
    """The ``read(run)`` function of ``spbench/metrics/<name>.py``."""
    return load_part("metrics", name).read


# ---------------------------------------------------------------- the data
def make_data(config: dict, seed: int) -> tuple[Ragged, dict, dict]:
    """The configuration's columns from the seed: geometry, extras, schema."""
    gen = importlib.import_module(f"spbench.reference.generators.{config['generator']}")
    data = gen.generate(config["sizes"], seed % 2**64)
    rng = np.random.default_rng((seed + 1) % 2**64)
    vpr = data.values_per_record()
    extras, schema = {}, {}
    for spec in config.get("extras", []):
        kind = importlib.import_module(f"spbench.reference.extras.{spec['kind']}")
        extras[spec["name"]] = kind.make(spec, rng, vpr)
        schema[spec["name"]] = np.dtype(spec["dtype"]).str
    return data, extras, schema


def forbidden_modules() -> list[str]:
    """Modules of ``jax``, ``jaxlib``, ``flax`` or the JAX package loaded."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def kernel_cache_env(root: Path = ROOT) -> None:
    """Every build and kernel cache in fixed directories inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(root / "build" / sub)


def import_program(root: Path = ROOT) -> None:
    """Put the port's package (``src/repro_torch``, beside ``spbench/``) on the path."""
    src = root / "src"
    if not (src / "repro_torch").is_dir():
        raise FileNotFoundError(f"the port's package is not at {src / 'repro_torch'}")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    importlib.import_module("repro_torch")


# ---------------------------------------------------------------- one run
@dataclass
class Run:
    """What a metric reader reads."""

    workload: str
    config: dict
    mix: dict
    setup_s: float
    write_s: float | None
    file_bytes: int | None
    n_points: int
    n_records: int
    window_s: float
    queries: list[QueryLog]
    spans: list[dict] | None = None          # obs spans of the window (traced run)
    main_thread: int | None = None           # the client's thread id in those spans
    device: object | None = None             # devtrace.DeviceTrace (traced run on the card)
    page_bytes: np.ndarray | None = None     # x + y bytes of each page, file order


def program_answer(res) -> Answer:
    """A ``read_columnar`` result as plain arrays (bit patterns for values)."""
    geo, extras, stats = res
    if geo is None:
        e8, e64 = np.zeros(0, np.uint8), np.zeros(0, np.int64)
        geo_parts = dict(x=e64, y=e64, rep=e8, defn=e8, types=e8, type_rep=e8)
    else:
        geo = geo.coords_to_host()
        geo_parts = dict(x=bits(geo.x), y=bits(geo.y), rep=geo.rep, defn=geo.defn,
                         types=geo.types, type_rep=geo.type_rep)
    return Answer(pages_read=stats.pages_read, records_scanned=stats.records_scanned,
                  n=stats.records_returned, extras={k: bits(v) for k, v in extras.items()},
                  **geo_parts)


def result_bytes(ans: Answer) -> int:
    """Bytes of the arrays the caller gets: coordinates and extra columns."""
    return int(ans.x.nbytes + ans.y.nbytes + sum(v.nbytes for v in ans.extras.values()))


def page_bytes(path: Path) -> np.ndarray:
    """x + y stored bytes of every page, file order, from the file's footer
    (``[footer][crc32c if v2][footer_nbytes u32][magic]``)."""
    import msgpack

    with open(path, "rb") as fh:
        fh.seek(-10, os.SEEK_END)
        tail = fh.read(10)
        n, magic = int.from_bytes(tail[:4], "little"), tail[4:]
        fh.seek(-10 - n, os.SEEK_END)
        blob = fh.read(n)
    if magic == b"SPQF2\x00":
        blob = blob[:-4]
    footer = msgpack.unpackb(blob, raw=False, strict_map_key=False)
    return np.asarray([px["nbytes"] + py["nbytes"] for rg in footer["row_groups"]
                       for px, py in zip(rg["x_pages"], rg["y_pages"])], np.int64)


def log(msg: str) -> None:
    print(f"[spbench] {msg}", file=sys.stderr, flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             t_start: float | None = None, control: str | None = None) -> dict:
    """Run ``cell`` once; returns the result line (a dict).

    ``device="cpu"`` runs the port's plain versions (the CPU tests);
    ``control="float32"`` puts the reference, computed in float32, in the
    program's place (no file is written).
    """
    t_start = time.perf_counter() if t_start is None else t_start
    kernel_cache_env()
    import_program()
    import torch

    from repro_torch import obs
    from repro_torch.core.columnar import from_ragged
    from repro_torch.core.writer import write_file

    on_card = device == "cuda"
    if on_card:
        from repro_torch.kernels import _build

        torch.cuda.init()
        t0 = time.perf_counter()
        built = _build.build_all(KERNEL_LIBS)
        for name in KERNEL_LIBS:
            _build.load(name)
        log(f"kernels built {built} in {time.perf_counter() - t0:.3f} s")
        torch.cuda.reset_peak_memory_stats()

    cfg, writer_kw = cell.config, dict(cell.config["writer"])
    t0 = time.perf_counter()
    data, extras, schema = make_data(cfg, seed)
    log(f"data: {data.n_records} records, {data.n_values} points in "
        f"{time.perf_counter() - t0:.3f} s")
    n_points, n_records = data.n_values, data.n_records

    with tempfile.TemporaryDirectory(prefix="spbench-") as tmp:
        path = Path(tmp) / f"{cfg['name']}.spqf"
        write_s = file_bytes = None
        if control is None:
            cols = from_ragged(data.types, data.coords, data.part_sizes, data.parts_per_record)
            c0, t0 = time.process_time(), time.perf_counter()
            write_file(path, columns=cols, extra=extras, extra_schema=schema, device=device,
                       **writer_kw)
            write_s = time.perf_counter() - t0
            file_bytes = path.stat().st_size
            del cols
            log(f"write: {file_bytes} bytes in {write_s:.3f} s ({time.process_time() - c0:.3f} "
                "CPU s)")
        t0 = time.perf_counter()
        oracle = Oracle(data, extras, writer_kw)
        del data
        warm, queries = cell.queries.make(cell.mix, oracle, seed)
        reference_s = time.perf_counter() - t0
        log(f"reference and {len(queries)} queries in {reference_s:.3f} s (not in set-up)")

        drv, mix = cell.driver, cell.mix
        if control is None:
            def call(q):   # (answer, bytes read)
                return drv.program(path, q, mix, device)
        else:
            def call(q):
                return drv.reference(oracle, q, mix, precision=control), 0

        warm_ans = call(warm)[0]
        if on_card:
            torch.cuda.synchronize()
        gc.collect()
        setup_s = time.perf_counter() - t_start - reference_s
        log(f"set-up {setup_s:.3f} s; window of {seconds} s")

        # ---------------------------------------------------------- window
        prof = tracer = None
        main = threading.get_ident()
        with contextlib.ExitStack() as stack:
            if trace:
                tracer = obs.enable()
                stack.callback(obs.disable)
                if on_card:
                    from torch.profiler import ProfilerActivity, profile, record_function

                    prof = stack.enter_context(
                        profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
                    mark_obs_us = (time.perf_counter_ns() - tracer.epoch_ns) / 1e3
                    stack.enter_context(record_function(devtrace.WINDOW_MARK))
            logs, answers, window_s = drv.window(call, queries, seconds)
        memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
        log(f"window: {len(logs)} queries in {window_s:.3f} s")
        for lg in logs:
            log(f"query {lg.query.target:.5f}: {lg.latency_s:.4f} s, {lg.cpu_s:.4f} CPU s")

        # ---------------------------------------------------------- after it
        devtr = None
        if prof is not None:
            tpath = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(tpath))
            devtr = devtrace.parse(tpath, mark_obs_us)
            tpath.unlink()
            prof = None
        pages = page_bytes(path) if (trace and control is None) else None

        # the check: every answer, the warm-up's too
        t0 = time.perf_counter()
        counts = [check.compare(warm_ans, drv.reference(oracle, warm, mix))]
        for lg, ans in zip(logs, answers):
            want = drv.reference(oracle, lg.query, mix)
            counts.append(check.compare(ans, want))
            lg.ref_hit_pages = want.hit_pages
            lg.pages_total = oracle.n_pages
            if ans is not None:
                lg.pages_read, lg.records_scanned = ans.pages_read, ans.records_scanned
                lg.records_returned, lg.result_bytes = ans.n, result_bytes(ans)
            del want
        totals = check.total(counts)
        correct = check.passed(totals)
        log(f"check of {len(counts)} answers in {time.perf_counter() - t0:.3f} s")
        del answers, warm_ans

    run = Run(cell.name, cfg, cell.mix, setup_s, write_s, file_bytes, n_points, n_records,
              window_s, logs, spans=tracer.spans() if tracer is not None else None,
              main_thread=main, device=devtr, page_bytes=pages)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = load_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    out = {"correct": bool(correct), "attempted": len(logs),
           "failed": sum(lg.error is not None for lg in logs), "metrics": metrics, "device": dev}
    if devtr is not None:
        dev["busy_s"] = devtr.busy_s()
        dev["window_s"] = devtr.window_s
        out["breakdown"] = {"device_ops": devtr.top_ops(10),
                            "idle_gaps": devtr.idle_by_span(run.spans or [], main, 10)}
    out["checks"] = {k: {"value": v, "limit": check.LIMIT} for k, v in totals.items()}
    errors = [lg.error for lg in logs if lg.error]
    if errors:
        log(f"first error: {errors[0]}")
    return out
