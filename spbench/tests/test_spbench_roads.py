"""The ``tiger-roads`` configuration: its generator (the parts and points of
the repository's ``roads_like``, the lines of a road adjacent), a tiny
``roads-bbox-large`` run on the CPU, and the comparison catching a level
fault that only multi-part records can have (a point inside a line read as
the start of a new line)."""

import copy

import numpy as np
import pytest

from spbench import harness
from spbench.reference.generators import tiger_roads_like

# small sizes that still give several row groups and pages, and bit-packed
# repetition streams
TINY_ROADS = {"n_roads": 2000}
TINY_WRITER = {"page_values": 4096, "row_group_records": 1500}


def tiny_roads():
    cell = harness.load_cell("roads-bbox-large")
    cell.config = copy.deepcopy(cell.config)
    cell.config["sizes"].update(TINY_ROADS)
    cell.config["writer"].update(TINY_WRITER)
    cell.mix = dict(cell.mix, sample_records=5000)
    return cell


@pytest.mark.parametrize("seed", [7, 2**31 + 11])
def test_the_generator_keeps_a_roads_lines_together(seed):
    from repro_torch.core.rle import MODE_PACKED, encode_levels
    from repro_torch.data.synthetic import roads_like

    sizes = {"n_roads": 3000, "mean_pts": 18}
    data = tiger_roads_like.generate(sizes, seed)
    again = tiger_roads_like.generate(sizes, seed)
    assert np.array_equal(data.coords.view(np.int64), again.coords.view(np.int64))
    assert np.all(data.types == tiger_roads_like.TYPE_MULTILINESTRING)
    # the parts and points are roads_like's, draw for draw
    want = roads_like(3000, mean_pts=18, seed=seed)
    assert np.array_equal(data.rep_levels(), want.rep)
    rep = data.rep_levels()
    assert set(np.unique(rep)) == {0, 2, 3} and encode_levels(rep)[0] == MODE_PACKED
    # a road is one place: its lines, each under 4 x 18 steps long, start
    # within a few steps of the line before
    line_start = np.cumsum(data.part_sizes) - data.part_sizes
    line_end = line_start + data.part_sizes - 1
    later = np.ones(len(data.part_sizes), bool)
    later[np.cumsum(data.parts_per_record) - data.parts_per_record] = False
    jump = np.abs(data.coords[line_start[later]] - data.coords[line_end[np.flatnonzero(later) - 1]])
    assert jump.max() < 10 * tiger_roads_like.STEP
    first = np.cumsum(data.parts_per_record) - data.parts_per_record
    width = (np.maximum.reduceat(np.maximum.reduceat(data.coords, line_start)[:, 0], first)
             - np.minimum.reduceat(np.minimum.reduceat(data.coords, line_start)[:, 0], first))
    assert len(width) == len(data.types) and width.max() < 3 * 4 * 18 * 2e-4 + 0.01
    # the towns spread the roads over the contiguous US
    x0, y0, x1, y1 = tiger_roads_like.US_BBOX
    assert np.ptp(data.coords[:, 0]) > 0.5 * (x1 - x0)
    assert np.ptp(data.coords[:, 1]) > 0.5 * (y1 - y0)


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_roads_run_is_correct_on_the_cpu(trace):
    cell = tiny_roads()
    assert cell.config["generator"] == "tiger_roads_like"
    out = harness.run_cell(cell, 2**31 + 29, 0.3, trace, device="cpu")
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert out["attempted"] >= 1 and out["failed"] == 0
    if not trace:
        assert {"setup_s", "bytes_per_point", "scan_mb_per_s"} <= set(out["metrics"])
    else:
        assert {"write_mpts_per_s", "host_cpu_s_per_gb.large",
                "transfer_share.large"} <= set(out["metrics"])


def test_float32_control_is_not_correct():
    out = harness.run_cell(tiny_roads(), 2**31 + 31, 0.2, False, device="cpu",
                           control="float32")
    assert not out["correct"]
    assert out["checks"]["x_bits_off"]["value"] > 0


def test_a_rep_3_read_as_2_makes_the_run_not_correct(monkeypatch):
    cell = tiny_roads()
    orig = cell.driver.program_answer

    def program_answer(res):   # one point inside a line read as a line's start
        ans = orig(res)
        inside = np.flatnonzero(ans.rep == 3)
        if len(inside):
            ans.rep = ans.rep.copy()
            ans.rep[inside[0]] = 2
        return ans
    monkeypatch.setattr(cell.driver, "program_answer", program_answer)
    out = harness.run_cell(cell, 2**31 + 37, 0.3, False, device="cpu")
    assert not out["correct"]
    assert out["checks"]["levels_off"]["value"] > 0
    assert out["checks"]["x_bits_off"]["value"] == 0
