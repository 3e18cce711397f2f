"""Each metric reader, and the device timeline, on a small synthetic trace."""

import json

import numpy as np
import pytest

from spbench import devtrace, harness, roofline
from spbench.harness import QueryLog, Run
from spbench.traffic import Query

from .conftest import all_metrics

Q = Query((0.0, 0.0, 1.0, 1.0), 0.1)


def synthetic_run() -> Run:
    qs = [QueryLog(Q, 2.0, 1.5, pages_read=3, pages_total=100, bytes_read=500_000_000,
                   records_scanned=10, records_returned=4, result_bytes=40_000_000,
                   ref_hit_pages=np.array([0, 1, 2])),
          QueryLog(Q, 4.0, 3.5, pages_read=1, pages_total=100, bytes_read=500_000_000,
                   records_scanned=5, records_returned=2, result_bytes=20_000_000,
                   ref_hit_pages=np.array([5]))]

    def span(name, ts, dur, **args):
        return {"name": name, "ts": ts, "dur": dur, "tid": 1, "args": args}
    spans = [span("scan.file", 0, 2_000_000), span("device.h2d", 100_000, 50_000),
             span("device.decode_launch", 200_000, 10_000, values=1000, width=64),
             span("device.refine_launch", 300_000, 20_000, values=1000, records=10, width=64),
             span("device.gather", 400_000, 30_000),
             span("scan.file", 2_000_000, 4_000_000), span("rg.plan", 2_100_000, 3_000_000),
             span("device.decode_launch", 5_500_000, 10_000, values=500, width=64)]
    dev = devtrace.DeviceTrace((0.0, 6_000_000.0), [
        (200_000.0, 200_004.0, "void decode_stream_kernel<64>(unsigned int const*)"),
        (300_000.0, 300_002.0, "void segminmax_refine<64>(void const*)"),
        (5_500_000.0, 5_500_002.0, "void decode_stream_kernel<64>(unsigned int const*)"),
        (100_000.0, 100_010.0, "Memcpy HtoD (Pageable -> Device)")])
    return Run("w", {}, {}, setup_s=80.0, write_s=40.0, file_bytes=1_000_000_000,
               n_points=100_000_000, n_records=2_000_000, window_s=6.0, queries=qs,
               spans=spans, main_thread=1, device=dev,
               page_bytes=np.array([10, 20, 30, 0, 0, 60], np.int64))


@pytest.mark.parametrize("name,want", [
    ("setup_s", 80.0),
    ("write_mpts_per_s", 2.5),
    ("bytes_per_point", 10.0),
    ("scan_mb_per_s", 10.0),
    ("host_cpu_s_per_gb.large", 5.0),
    ("transfer_share.large", 100 * 0.08 / 6.0),
    ("fp_delta_decode_roofline.large",
     100 * (120 + 1500 * 8) / 3.35e12 / 6e-6),
    ("segminmax_refine_roofline.large", 100 * (8000 + 10) / 3.35e12 / 2e-6),
    ("device_idle.large", 100 * (1 - 18e-6 / 6.0)),
])
def test_reader_on_a_synthetic_trace(name, want):
    assert harness.load_reader(name)(synthetic_run()) == pytest.approx(want, rel=1e-9)


def test_every_reader_returns_nothing_where_there_is_nothing_to_read():
    empty = Run("w", {}, {}, setup_s=1.0, write_s=None, file_bytes=None, n_points=0,
                n_records=0, window_s=0.0, queries=[])
    names = all_metrics()
    assert len(names) == 9
    for name in names:
        if name != "setup_s":
            assert harness.load_reader(name)(empty) is None, name


def test_roofline_share_is_none_without_kernel_time():
    assert roofline.share_pct(1000, 0.0) is None
    assert roofline.decode_bytes(100, 10, 64) == 180
    assert roofline.refine_bytes(10, 3, 32) == 43


def test_idle_gaps_are_named_by_the_innermost_span():
    run = synthetic_run()
    gaps = dict(run.device.idle_by_span(run.spans, 1))
    total = sum(gaps.values())
    assert total == pytest.approx(6.0 - run.device.busy_s())
    # rg.plan (3 s) is the innermost span over most of the second query
    assert gaps["rg.plan"] == pytest.approx(3.0)
    assert set(gaps) <= {"rg.plan", "scan.file", "device.h2d", "device.decode_launch",
                         "device.refine_launch", "device.gather"}


def test_parse_reads_device_events_inside_the_window(tmp_path):
    doc = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "spbench.window", "ts": 1000, "dur": 500},
        {"ph": "X", "cat": "kernel", "name": "void decode_stream_kernel<64>(int)", "ts": 1100,
         "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1490, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "early", "ts": 900, "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "ts": 1200, "dur": 5}]}
    p = tmp_path / "t.json"
    p.write_text(json.dumps(doc))
    tr = devtrace.parse(p, mark_obs_us=400.0)
    assert tr.window == (1000.0, 1500.0) and tr.span_offset_us == 600.0
    assert tr.busy_s() == pytest.approx(20e-6)      # the copy is clipped at the window's end
    assert tr.kernel_s("decode_stream_kernel") == pytest.approx(10e-6)
    assert tr.top_ops()[0] == ["decode_stream_kernel<64>", pytest.approx(10e-6)]
