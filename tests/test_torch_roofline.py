"""The port's roofline tools (``repro_torch.launch.{roofline,dryrun,report}``)
against the reference's (``tests/test_roofline.py``'s checks).

Exact equality where the arithmetic is the same (ring bytes, the
correction, parameter and model FLOP counts, report lines); the H100
figures for the roofline terms; and a dry run of a reduced cell on a fake
(2, 2) process group whose per-rank FLOPs lie within 1 % of
``FlopCounterMode``'s count of the same step on one device divided by 4
(the products split evenly four ways: batch over 'data', heads and widths
over 'model').
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch.roofline import (Corrected, collectives_from_trace,
                                         correct_with_calibration, count_params, link_bw,
                                         model_flops, roofline_terms)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

# tests/test_roofline.py's HLO module, one record per collective: operand
# bytes, output bytes and the group's ranks
_BF16_X = 32 * 4096 * 128 * 2
RECORDS = [
    {"kind": "all-reduce", "in_bytes": _BF16_X, "out_bytes": _BF16_X, "ranks": [0, 1, 2, 3]},
    {"kind": "all-gather", "in_bytes": 4 * 2048 * 4, "out_bytes": 64 * 2048 * 4,
     "ranks": list(range(16))},
    {"kind": "reduce-scatter", "in_bytes": 16 * 128 * 4, "out_bytes": 8 * 128 * 4,
     "ranks": [0, 1]},
    {"kind": "collective-permute", "in_bytes": _BF16_X, "out_bytes": 1024 * 4, "ranks": [0, 1]},
    {"kind": "all-to-all", "in_bytes": 16 * 128 * 4, "out_bytes": 16 * 64 * 4,
     "ranks": [0, 1, 2, 3]},
]


def test_collectives_from_trace_equal_reference_ring_model():
    pytest.importorskip("jax")
    from test_roofline import HLO

    from repro.launch.roofline import parse_collectives

    want = parse_collectives(HLO)
    got = collectives_from_trace(RECORDS)
    assert set(got) == set(want)
    for kind, w in want.items():
        for key in ("count", "ring_bytes", "raw_bytes"):
            assert got[kind][key] == w[key], (kind, key)
    # every group above lies in one 8-card node but the 16-rank all-gather
    assert got["all-gather"]["link_s"] == got["all-gather"]["ring_bytes"] / 50e9
    assert got["all-reduce"]["link_s"] == got["all-reduce"]["ring_bytes"] / 450e9
    assert link_bw(range(8)) == 450e9 and link_bw([7, 8]) == 50e9


def test_correction_math():
    group = {"flops": 10.0, "bytes": 100.0, "coll_ring": 5.0, "coll_raw": 3.0}
    layer = {"flops": 1.0, "bytes": 10.0, "coll_ring": 0.5, "coll_raw": 0.3}
    outside = {"flops": 7.0, "bytes": 70.0, "coll_ring": 0.0, "coll_raw": 0.0}
    c = correct_with_calibration(group, layer, outside, n_layers=38, period=6)
    assert c == Corrected(flops=7.0 + 6 * 10.0 + 2 * 1.0, bytes=70.0 + 6 * 100.0 + 2 * 10.0,
                          coll_ring=6 * 5.0 + 2 * 0.5, coll_raw=6 * 3.0 + 2 * 0.3)


def test_roofline_terms_dominance_at_h100_figures():
    t = roofline_terms(flops=989e12, bytes_=0.0, coll_ring=0.0)
    assert t["dominant"] == "compute" and t["compute_s"] == pytest.approx(1.0)
    assert t["roofline_fraction"] == pytest.approx(1.0)
    t = roofline_terms(flops=67e12, bytes_=0.0, coll_ring=0.0, flops_peak=67e12)
    assert t["compute_s"] == pytest.approx(1.0)
    t = roofline_terms(flops=989e10, bytes_=3.35e12, coll_ring=0.0)
    assert t["dominant"] == "memory" and t["memory_s"] == pytest.approx(1.0)
    t = roofline_terms(flops=0.0, bytes_=0.0, coll_ring=450e9 * 3)
    assert t["dominant"] == "collective" and t["collective_s"] == pytest.approx(3.0)
    t = roofline_terms(flops=0.0, bytes_=0.0, coll_ring=1.0, collective_s=2.0)
    assert t["collective_s"] == 2.0 and t["bound_s"] == 2.0


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_count_params_and_model_flops_equal_reference(arch):
    pytest.importorskip("jax")
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget
    from repro.launch import roofline as jr

    cfg, jcfg = get_config(arch), jget(arch)
    for active in (False, True):
        assert count_params(cfg, active) == jr.count_params(jcfg, active)
    for name in SHAPES:
        assert model_flops(cfg, SHAPES[name]) == jr.model_flops(jcfg, JSHAPES[name]), name


def test_input_specs_allocate_nothing():
    import torch

    from repro_torch.launch.dryrun import input_specs
    from repro_torch.models import flatten_with_paths

    cfg = get_config("internlm2-1.8b")
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        specs = input_specs(cfg, SHAPES[name])
        leaves = [t for _, t in flatten_with_paths(specs)]
        assert leaves and all(isinstance(t, torch.Tensor) and t.is_meta for t in leaves), name
    tr = input_specs(cfg, SHAPES["train_4k"])
    assert set(tr) == {"params", "opt_state", "batch"}
    assert tuple(tr["batch"]["tokens"].shape) == (16, 16, 4096)   # grad_accum 16
    de = input_specs(cfg, SHAPES["decode_32k"])
    assert tuple(de["tokens"].shape) == (128, 1)
    assert de["cache"]["layers"]["k"].shape[2] == 32768
    # arctic's 1.9 TB of float32 parameters, described without a byte
    arctic = input_specs(get_config("arctic-480b"), SHAPES["train_4k"])
    n = sum(t.numel() for _, t in flatten_with_paths(arctic["params"]))
    assert n * 4 > 1.8e12


_DRYRUN = """
import json, sys
import numpy as np
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch.dryrun import fake_group, run_cell
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import build_model
from repro_torch.train.optimizer import OptConfig, opt_init
from repro_torch.train.train_loop import make_train_step

cfg = get_config("internlm2-1.8b").reduced()
shape = ShapeConfig("tiny_train", 64, 8, "train")
with fake_group(4):
    rec = run_cell("internlm2-1.8b", "tiny_train", multi_pod=False, cfg=cfg, shape=shape,
                   mesh_shape=MeshShape(("data", "model"), (2, 2)), counting="both")
p = build_model(cfg).init(0, device="cpu")
step, _ = make_train_step(cfg, OptConfig(), 8, 64, device="cpu")
with FlopCounterMode(display=False) as fc:
    step(p, opt_init(OptConfig(), p), {"tokens": np.zeros((1, 8, 64), np.int32)})
rec["one_device_flops"] = fc.get_total_flops()
print("RESULT", json.dumps(rec))
"""


def test_dry_run_of_a_reduced_cell_on_a_fake_2x2_group():
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_DRYRUN)], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    rec = json.loads(r.stdout.split("RESULT ", 1)[1])
    assert rec["status"] == "ok" and rec["chips"] == 4
    flops = rec["cost_raw"]["flops"]
    assert flops == pytest.approx(rec["one_device_flops"] / 4, rel=0.01)
    # eager counts every layer: the reference's L-sweep lands on the same total
    assert rec["calibration"]["flops_vs_direct"] == pytest.approx(1.0, rel=0.01)
    coll = rec["collectives"]
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(coll)   # FSDP, TP
    assert all(c["link_s"] > 0 for c in coll.values())
    assert 0 < rec["memory"]["peak_hbm_bytes"] < 1e9 and rec["memory"]["fits"]
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["useful_flops_ratio"] > 0 and rec["sharding_fallbacks"] == []


def _record(arch, shape, peak):
    return {"arch": arch, "shape": shape, "status": "ok", "compile_s": 12.0,
            "memory": {"peak_hbm_bytes": peak},
            "collectives": {"all-gather": {"count": 3}, "all-reduce": {"count": 5}},
            "roofline": {"compute_s": 1.2e-3, "memory_s": 3.4e-4, "collective_s": 5.6e-5,
                         "dominant": "compute", "roofline_fraction": 1.0},
            "useful_flops_ratio": 0.77}


def test_report_tables_equal_reference():
    pytest.importorskip("jax")
    from repro.launch import report as jreport

    from repro_torch.launch import report

    recs = {("qwen3-8b", "train_4k", "pod1"): _record("qwen3-8b", "train_4k", 9 * 2**30),
            ("qwen3-8b", "train_4k", "pod2"): _record("qwen3-8b", "train_4k", 5 * 2**30),
            ("granite-20b", "decode_32k", "pod1"): _record("granite-20b", "decode_32k", 1e12),
            ("whisper-medium", "long_500k", "pod1"): {"status": "skipped",
                                                     "reason": "encoder-only arch " * 4},
            ("mamba2-130m", "train_4k", "pod1"): {"status": "error"}}
    assert report.roofline_table(recs) == jreport.roofline_table(recs)
    assert report.multipod_table(recs) == jreport.multipod_table(recs)
    new = {k: json.loads(json.dumps(v)) for k, v in recs.items()}
    new[("qwen3-8b", "train_4k", "pod1")]["roofline"]["compute_s"] = 1.0e-3
    cells = [("qwen3-8b", "train_4k"), ("granite-20b", "decode_32k")]
    assert report.diff_table(recs, new, cells) == jreport.diff_table(recs, new, cells)


_DRYRUN_MEMORY = """
import json
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch.dryrun import fake_group, run_cell
from repro_torch.launch.mesh import MeshShape

cfg = get_config("internlm2-1.8b").reduced()
shape = ShapeConfig("tiny_train", 64, 8, "train")
out = {}
with fake_group(4):
    for counting in ("direct", "calibrated"):
        out[counting] = run_cell("internlm2-1.8b", "tiny_train", multi_pod=False, cfg=cfg,
                                 shape=shape, mesh_shape=MeshShape(("data", "model"), (2, 2)),
                                 counting=counting)
print("RESULT", json.dumps(out))
"""


def test_dry_run_splits_the_peak_by_category():
    """``memory_categories`` beside ``memory``: MemTracker's own categories
    at the peak sum to the peak; the parameters and optimizer state handed
    to it are reported apart (on a mesh it counts their DTensor wrappers as
    0 bytes); the L-sweep extrapolates them like the peak."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_DRYRUN_MEMORY)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    recs = json.loads(r.stdout.split("RESULT ", 1)[1])
    for counting, rec in recs.items():
        peak, cats = rec["memory"]["peak_hbm_bytes"], rec["memory_categories"]
        assert set(rec["memory"]) == {"peak_hbm_bytes", "hbm_bytes", "fits"}
        assert sum(cats["tracker"].values()) == pytest.approx(peak, rel=1e-9, abs=2), counting
        assert {"Activation", "Temp"} <= set(cats["tracker"]), cats      # forward, backward
        assert set(cats["held"]) == {"parameters", "optimizer_state"}
        assert cats["held"]["parameters"] > 0
        assert cats["held"]["optimizer_state"] == pytest.approx(
            2 * cats["held"]["parameters"], rel=0.01)                     # AdamW's mu and nu
        assert cats["held_in_peak"] == 0                                  # DTensor wrappers
        assert cats["peak_plus_held_bytes"] == pytest.approx(
            peak + sum(cats["held"].values()), rel=1e-9, abs=2)
    assert recs["calibrated"]["memory_categories"]["held"]["parameters"] == pytest.approx(
        recs["direct"]["memory_categories"]["held"]["parameters"], rel=1e-6)
