"""The benchmark's CPU tests: small sizes, the port's plain versions."""

import copy
import os
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# small sizes that still give several row groups and pages
TINY_SIZES = {"porto-taxi": {"n_traj": 1200}, "ebird-points": {"n_points": 4000}}
TINY_WRITER = {"page_values": 4096, "row_group_records": 1500}


def all_metrics() -> list[str]:
    """Every metric that has a reader in ``spbench/metrics/``."""
    d = os.path.join(ROOT, "spbench", "metrics")
    return sorted(f[:-3] for f in os.listdir(d) if f.endswith(".py"))


def tiny_cell(config: str, mix: str):
    """``config`` under ``mix``, found by name, cut to a size a test run can
    hold, with every metric of BENCHMARK.json."""
    import json

    from spbench import harness

    listed = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    bench = {"workloads": [{"name": "tiny", "config": config, "traffic": mix, "chips": 1}],
             "configs": [{"name": config, "file": f"spbench/configs/{config}.json"}],
             "end_to_end": [{"name": m["name"], "unit": m["unit"]} for m in listed["end_to_end"]],
             "per_layer": [{"name": m["name"], "unit": m["unit"]} for m in listed["per_layer"]]}
    cell = harness.load_cell("tiny", bench=bench)
    cell.config = copy.deepcopy(cell.config)
    cell.config["sizes"].update(TINY_SIZES[config])
    cell.config["writer"].update(TINY_WRITER)
    cell.mix = dict(cell.mix, sample_records=5000)
    return cell


@pytest.fixture
def tiny():
    return tiny_cell


@pytest.fixture(autouse=True)
def fresh_port_telemetry():
    """A traced run leaves the port's tracer and registry readable; leave
    them empty and off for whatever test this worker runs next."""
    yield
    obs = sys.modules.get("repro_torch.obs")
    if obs is not None:
        obs.enable()
        obs.disable()
