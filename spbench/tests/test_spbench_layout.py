"""BENCHMARK.json against the benchmark's contract, and the data-driven
layout: every cell's configuration, mix and metric reader found by name."""

import json
import re
import shutil
from pathlib import Path

from spbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["spbench"]
    assert BENCH["command"][1].startswith("spbench/") and len(BENCH["command"]) <= 32
    assert all(one_line(w) for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and one_line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)


def test_metrics_follow_the_contract():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert one_line(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        if m["name"].endswith("roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for w in cells:
        cell = harness.load_cell(w)
        assert "setup_s" in [m["name"] for m in cell.end_to_end]
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_every_cell_finds_its_files_by_name():
    used = set()
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.config["name"] == w["config"] and cell.mix["name"] == w["traffic"]
        conf = next(c for c in BENCH["configs"] if c["name"] == w["config"])
        assert conf["file"] == f"spbench/configs/{w['config']}.json"
        assert cell.config["reduced"] == conf["reduced"]
        used.add(w["config"])
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.load_reader(m["name"]))
    assert used == {c["name"] for c in BENCH["configs"]}


def test_a_new_configuration_and_mix_are_found_by_name(tmp_path):
    """Adding a cell is new files and new entries: nothing that exists changes."""
    (tmp_path / "spbench" / "configs").mkdir(parents=True)
    (tmp_path / "spbench" / "traffic").mkdir()
    conf = json.loads((ROOT / "spbench/configs/porto-taxi.json").read_text())
    conf.update(name="porto-half", sizes={"n_traj": 800}, extras=conf["extras"][:1])
    conf["writer"].update(page_values=4096, row_group_records=500)
    (tmp_path / "spbench/configs/porto-half.json").write_text(json.dumps(conf))
    mix = json.loads((ROOT / "spbench/traffic/bbox-large.json").read_text())
    mix.update(name="bbox-mid", selectivity=[0.02, 0.05], strata=3, cycles=2,
               sample_records=2000)
    (tmp_path / "spbench/traffic/bbox-mid.json").write_text(json.dumps(mix))
    bench = dict(BENCH, configs=[{"name": "porto-half", "source": "x", "reduced": [],
                                  "file": "spbench/configs/porto-half.json", "why": "x"}],
                 workloads=[{"name": "porto-bbox-mid", "config": "porto-half",
                             "traffic": "bbox-mid", "chips": 1, "why": "x"}],
                 end_to_end=[m for m in BENCH["end_to_end"] if "workloads" not in m],
                 per_layer=[])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("porto-bbox-mid", root=tmp_path)
    assert cell.config["sizes"] == {"n_traj": 800} and cell.mix["strata"] == 3
    out = harness.run_cell(cell, 5, 0.2, False, device="cpu")
    assert out["correct"] and set(out["metrics"]) >= {"setup_s", "bytes_per_point"}
    shutil.rmtree(tmp_path / "spbench")


FIXED_BOXES = '''"""Boxes given in the mix file as shares of the data's extent."""
from spbench.traffic import Query


def make(mix, oracle, seed):
    x0, x1 = float(oracle.xmin.min()), float(oracle.xmax.max())
    y0, y1 = float(oracle.ymin.min()), float(oracle.ymax.max())
    qs = [Query((x0 + a * (x1 - x0), y0 + b * (y1 - y0), x0 + c * (x1 - x0),
                 y0 + d * (y1 - y0)), 0.0) for a, b, c, d in mix["boxes"]]
    return qs[0], qs
'''

GEOMETRY_READ = '''"""A bbox read of the geometry alone, one client in a closed loop."""
from spbench.harness import program_answer
from spbench.traffic import closed_loop

window = closed_loop


def program(path, query, mix, device):
    from repro_torch.core.reader import SpatialParquetReader

    with SpatialParquetReader(path) as r:
        res = r.read_columnar(query.bbox, columns=("geometry",), refine=True,
                              device=device)
    return program_answer(res), res[2].bytes_read


def reference(oracle, query, mix, precision="float64"):
    want = oracle.expect(query.bbox, precision=precision)
    want.extras = {}
    return want
'''


def test_a_mix_of_a_new_kind_is_found_by_name(tiny, tmp_path):
    """A mix with its own query generator and its own driver (another entry
    point) is three new files: the harness finds each by name."""
    for kind, name, text in (("queries", "fixed_boxes", FIXED_BOXES),
                             ("drivers", "geometry_read", GEOMETRY_READ)):
        (tmp_path / "spbench" / kind).mkdir(parents=True)
        (tmp_path / "spbench" / kind / f"{name}.py").write_text(text)
    (tmp_path / "spbench" / "traffic").mkdir()
    (tmp_path / "spbench" / "configs").mkdir()
    shutil.copy(ROOT / "spbench/configs/porto-taxi.json", tmp_path / "spbench/configs")
    mix = {"name": "geo-fixed", "queries": "fixed_boxes", "driver": "geometry_read",
           "boxes": [[0.2, 0.2, 0.5, 0.6], [0.0, 0.0, 1.0, 0.3]]}
    (tmp_path / "spbench/traffic/geo-fixed.json").write_text(json.dumps(mix))
    bench = dict(BENCH, workloads=[{"name": "porto-geo", "config": "porto-taxi",
                                    "traffic": "geo-fixed", "chips": 1, "why": "x"}])
    cell = harness.load_cell("porto-geo", root=tmp_path, bench=bench)
    assert Path(cell.queries.__file__).parent == tmp_path / "spbench" / "queries"
    assert Path(cell.driver.__file__).parent == tmp_path / "spbench" / "drivers"
    small = tiny("porto-taxi", "bbox-large")
    cell.config = small.config
    out = harness.run_cell(cell, 11, 0.2, False, device="cpu")
    # the default driver returns the extra columns, which this reference leaves out
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1


def test_the_references_work_is_not_set_up(tiny, monkeypatch):
    """``setup_s`` leaves out the reference's work and the queries' drawing."""
    import time

    cell = tiny("porto-taxi", "bbox-large")
    make = cell.queries.make

    def slow_make(*a):
        time.sleep(2.0)
        return make(*a)
    monkeypatch.setattr(cell.queries, "make", slow_make)
    t0 = time.perf_counter()
    out = harness.run_cell(cell, 13, 0.2, False, device="cpu", t_start=t0)
    assert out["correct"]
    assert out["metrics"]["setup_s"]["value"] <= time.perf_counter() - t0 - 2.0


def test_a_part_that_is_not_there_is_named():
    import pytest

    with pytest.raises(FileNotFoundError, match="drivers"):
        harness.load_part("drivers", "no_such_driver", ROOT)


def test_the_closed_loop_counts_an_answer_that_never_comes():
    from spbench.traffic import Query, closed_loop

    qs = [Query((0.0, 0.0, 1.0, 1.0), 0.1), Query((0.0, 0.0, 2.0, 2.0), 0.2)]

    def call(q):
        if q.target > 0.15:
            raise RuntimeError("lost")
        return "answer", 7
    logs, answers, window_s = closed_loop(call, qs, 0.05)
    assert len(logs) == len(answers) >= 2 and window_s >= 0.05
    assert [lg.query for lg in logs[:3]] == [qs[0], qs[1], qs[0]][:len(logs[:3])]
    assert answers[0] == "answer" and logs[0].bytes_read == 7 and logs[0].error is None
    assert answers[1] is None and "lost" in logs[1].error


def test_square_boxes_meet_their_targets_in_the_same_order_for_every_seed(tiny):
    from spbench.reference.oracle import Oracle
    from spbench.traffic import load_part

    cell = tiny("ebird-points", "bbox-large")
    gen = load_part("queries", cell.mix["queries"])
    orders = []
    for seed in (3, 2**31 + 11):
        data, extras, _ = harness.make_data(cell.config, seed)
        oracle = Oracle(data, extras, cell.config["writer"])
        warm, seq = gen.make(cell.mix, oracle, seed)
        assert len(seq) == cell.mix["strata"] * cell.mix["cycles"]
        for q in seq:
            got = oracle.expect(q.bbox).n / oracle.n_records
            assert abs(got - q.target) < 0.05, (got, q.target)
        orders.append([q.target for q in seq])
    assert orders[0] == orders[1]
