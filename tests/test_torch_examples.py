"""The port's twins of the six examples (``examples/torch/``) and the kernel
build's observability (``repro_torch/kernels/_build.py``).

Each twin runs on the CPU in a subprocess that blocks ``jax`` and ``repro``
(``sys.modules[...] = None``, as ``tests/test_torch_isolation.py`` does),
with ``--device cpu`` and, for the four data twins, ``--device host``.
quickstart, serve_queries and spatial_analytics run at the reference's own
sizes, and their fact lines (timings and paths masked by
``chip_smoke.example_facts``) must equal the reference example's own output
as text. trace_scan's facts are held against the reference scanner called
here on the same seeded lake (``device="cpu"``, the reference's host path),
which keeps interpret-mode Pallas off the clock. The LM twins run at the
sizes the verify notes use for the reference and must finish with a falling
loss. The build's span and counters are held with ``nvcc`` and the library
loader replaced by stand-ins.
"""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
TWINS = ROOT / "examples" / "torch"
NAMES = ("quickstart", "trace_scan", "serve_queries", "spatial_analytics",
         "train_trajectory_lm", "serve_lm")
DATA = NAMES[:4]

sys.path.insert(0, str(ROOT))
from chip_smoke import example_facts  # noqa: E402

# blocks the JAX package and the reference, then runs argv[1] as __main__
_RUN_BLOCKED = ("import runpy, sys\n"
                "sys.modules['jax'] = None\n"
                "sys.modules['repro'] = None\n"
                "sys.argv = sys.argv[1:]\n"
                "runpy.run_path(sys.argv[0], run_name='__main__')\n")


def _env(tmp: Path, **extra) -> dict:
    # two intra-op threads: the tests share the machine with other workers
    return dict(os.environ, PYTHONPATH=str(SRC), TMPDIR=str(tmp), OMP_NUM_THREADS="2",
                **extra)


def run_twin(name: str, args, tmp: Path):
    tmp.mkdir(parents=True, exist_ok=True)
    out = subprocess.run([sys.executable, "-c", _RUN_BLOCKED, str(TWINS / f"{name}.py"),
                          *args], cwd=tmp, env=_env(tmp), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out


def run_reference(name: str, args, tmp: Path) -> str:
    tmp.mkdir(parents=True, exist_ok=True)
    out = subprocess.run([sys.executable, str(ROOT / "examples" / f"{name}.py"), *args],
                         cwd=tmp, env=_env(tmp, JAX_PLATFORMS="cpu"), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _add_arguments(path: Path) -> list[str]:
    """Every ``add_argument(...)`` call of a script, as source text."""
    src = path.read_text()
    return [ast.get_source_segment(src, node) for node in ast.walk(ast.parse(src))
            if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"]


# ---------------------------------------------------------------- the twins
@pytest.mark.parametrize("name", NAMES)
def test_twin_imports_only_the_port(name):
    for node in ast.walk(ast.parse((TWINS / f"{name}.py").read_text())):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            assert m.split(".")[0] not in ("jax", "jaxlib", "repro", "ml_dtypes"), (name, m)


@pytest.mark.parametrize("name", NAMES)
def test_twin_keeps_reference_arguments_and_adds_device(name):
    ref = _add_arguments(ROOT / "examples" / f"{name}.py")
    twin = _add_arguments(TWINS / f"{name}.py")
    ref = [a for a in ref if '"--device"' not in a]     # serve_queries: "cpu" / "jax"
    device = [a for a in twin if '"--device"' in a]
    assert [a for a in twin if '"--device"' not in a] == ref
    choices = ('("cuda", "cpu", "host")' if name in DATA else '("cuda", "cpu")')
    assert device == [f'ap.add_argument("--device", default="cuda", choices={choices})']


@pytest.fixture(scope="module")
def default_device_runs(tmp_path_factory):
    """Each twin started with no arguments, in one process with both
    packages blocked: without a card every one must raise asking for it."""
    tmp = tmp_path_factory.mktemp("default_device")
    child = ("import runpy, sys\n"
             "sys.modules['jax'] = None\n"
             "sys.modules['repro'] = None\n"
             "for path in sys.argv[1:]:\n"
             "    sys.argv = [path]\n"
             "    try:\n"
             "        runpy.run_path(path, run_name='__main__')\n"
             "    except RuntimeError as e:\n"
             "        print(path, 'RAISED', str(e).splitlines()[0])\n"
             "    else:\n"
             "        print(path, 'RAN')\n")
    out = subprocess.run([sys.executable, "-c", child,
                          *[str(TWINS / f"{n}.py") for n in NAMES]],
                         cwd=tmp, env=_env(tmp, CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return {Path(ln.split()[0]).stem: ln for ln in out.stdout.splitlines()}


@pytest.mark.parametrize("name", NAMES)
def test_twin_default_device_asks_for_a_card(default_device_runs, name):
    line = default_device_runs[name]
    assert "RAISED" in line and "no CUDA device" in line, line


@pytest.fixture(scope="module")
def reference_facts(tmp_path_factory):
    """The reference examples' facts, each run once at its own defaults
    (serve_queries at ``--device cpu``, the reference's host path)."""
    cache = {}

    def get(name):
        if name not in cache:
            args = ["--device", "cpu"] if name == "serve_queries" else []
            text = run_reference(name, args, tmp_path_factory.mktemp(f"ref_{name}"))
            cache[name] = example_facts(name, text)
        return cache[name]
    return get


@pytest.mark.parametrize("device", ["cpu", "host"])
@pytest.mark.parametrize("name", ["quickstart", "serve_queries", "spatial_analytics"])
def test_data_twin_prints_the_reference_facts(reference_facts, tmp_path, name, device):
    out = run_twin(name, ["--device", device], tmp_path)
    got = example_facts(name, out.stdout)
    assert got and got == reference_facts(name)


def _reference_trace_scan_facts(tmp: Path) -> list[str]:
    """trace_scan's fact lines from the reference's own scanner on the same
    seeded lake, traced as the example traces it."""
    from repro import obs
    from repro.core.columnar import from_ragged
    from repro.dataset import SpatialDatasetScanner, write_dataset

    rng = np.random.default_rng(0)
    n = 40_000
    pts = np.round(rng.uniform(-100, 100, (n, 2)), 6)
    cols = from_ragged(np.ones(n, np.uint8), pts, np.ones(n, np.int64), np.ones(n, np.int64))
    root = tmp / "lake"
    write_dataset(root, columns=cols, n_shards=4, sort="hilbert")
    sc = SpatialDatasetScanner(root, max_workers=4)
    bbox = (-50.0, -50.0, 50.0, 50.0)
    sc.scan(bbox=bbox, refine=True, device="cpu")
    obs.enable()
    try:
        _, _, stats = sc.scan(bbox=bbox, refine=True, device="cpu")
    finally:
        obs.disable()
    counters = obs.snapshot()["counters"]
    # disable() keeps the registry readable: leave a fresh, empty one, so a
    # later test in this process that reads the module's snapshot sees none
    obs.enable()
    obs.disable()
    return ([f"scan: {stats.records_returned}/{stats.records_scanned} records, "
             f"{stats.bytes_read}/{stats.bytes_total} bytes read"]
            + [f"bytes pruned at {level} level: {counters.get(f'pruned.{level}_bytes', 0)}"
               for level in ("shard", "page", "record")])


@pytest.mark.parametrize("device", ["cpu", "host"])
def test_trace_scan_twin_facts_equal_reference_scanner(tmp_path, device):
    out = run_twin("trace_scan", ["--device", device], tmp_path / "twin")
    want = _reference_trace_scan_facts(tmp_path)
    assert example_facts("trace_scan", out.stdout) == want
    assert "kernels: 0 builds, 0 loads, 0 cache hits" in out.stdout    # nothing built on the CPU
    import json
    trace = json.loads((tmp_path / "twin" / "scan_trace.json").read_text())
    names = {e["name"] for e in trace["traceEvents"] if e.get("ph") == "X"}
    assert "scan.dataset" in names
    assert any(n.startswith("device.") for n in names) == (device == "cpu")


def _losses(text: str) -> list[float]:
    return [float(m) for m in re.findall(r"^\[train\] step \d+ loss=([\d.]+)", text, re.M)]


def test_train_trajectory_lm_twin_loss_falls(tmp_path):
    out = run_twin("train_trajectory_lm", ["--steps", "6", "--n-traj", "150",
                                           "--global-batch", "4", "--seq", "64",
                                           "--device", "cpu"], tmp_path)
    first, last = map(float, re.search(r"\[train\] loss ([\d.]+) -> ([\d.]+) over 6 steps",
                                       out.stdout).groups())
    assert last < first
    assert re.search(r"\[ckpt\] compression ratio [\d.]+x", out.stdout)


def test_serve_lm_twin_serves_after_a_falling_loss(tmp_path):
    out = run_twin("serve_lm", ["--requests", "2", "--max-new", "4", "--warm-steps", "2",
                                "--device", "cpu"], tmp_path)
    losses = _losses(out.stdout)
    assert len(losses) == 2 and losses[-1] < losses[0]
    assert re.search(r"^\[serve\] 2 requests, 8 tokens in ", out.stdout, re.M)
    assert len(re.findall(r"^  req \d: ttfb \d+ms, 4 new tokens", out.stdout, re.M)) == 2


# ------------------------------------------------------ build observability
@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    """``_build`` with an empty ``build/`` of its own, ``nvcc`` replaced by a
    job that writes a stand-in library, and ``ctypes.CDLL`` by an object
    whose every attribute is a settable function."""
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_entries", {})
    monkeypatch.setattr(_build, "logs", {})
    started = []

    class Proc:
        returncode = 0

        def communicate(self):
            return b"ptxas info    : Used 32 registers", None

    def start(name):
        out = _build._lib_path(name)
        started.append(name)
        tmp = out.with_suffix(".tmp")
        tmp.write_bytes(b"library")
        return Proc(), tmp, out

    class Lib:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, fn_name):
            def fn(*args):
                return 0
            return fn

    monkeypatch.setattr(_build, "_start", start)
    monkeypatch.setattr(_build.ctypes, "CDLL", Lib)
    return started


def _counters():
    from repro_torch import obs

    c = obs.snapshot()["counters"]
    return {k: c.get(f"kernel.{k}", 0) for k in ("builds", "loads", "cache_hits")}


def test_build_span_and_counters(fake_toolchain):
    from repro_torch import obs
    from repro_torch.kernels import _build

    tracer = obs.enable()
    try:
        _build.load("page_minmax")
        spans = tracer.spans("kernel.build")
        assert [(s["cat"], s["args"]["source"]) for s in spans] == [("build", "page_minmax")]
        assert _counters() == {"builds": 1, "loads": 0, "cache_hits": 0}
        assert _build.load("page_minmax") is _build.load("page_minmax")   # cached: nothing
        assert _counters() == {"builds": 1, "loads": 0, "cache_hits": 0}
        # a new process: the library is in build/ and nothing is loaded
        _build._libs.clear()
        _build.load("page_minmax")
        assert _counters() == {"builds": 1, "loads": 1, "cache_hits": 0}
        assert len(tracer.spans("kernel.build")) == 1
        assert fake_toolchain == ["page_minmax"]
    finally:
        obs.disable()


def test_entry_cache_hits_and_compile_cache_stats(fake_toolchain):
    from repro_torch import obs
    from repro_torch.kernels import _build
    from repro_torch.kernels.fp_delta import compile_cache_stats

    assert compile_cache_stats is _build.compile_cache_stats
    obs.enable()
    try:
        fn = _build.entry("page_minmax", "pmm_page_minmax", [], None)
        stats = compile_cache_stats()
        assert stats == {"count": 2, "keys": ["page_minmax", "page_minmax:pmm_page_minmax"]}
        assert _counters() == {"builds": 1, "loads": 0, "cache_hits": 0}
        for _ in range(3):
            assert _build.entry("page_minmax", "pmm_page_minmax", [], None) is fn
        assert _counters()["cache_hits"] == 3
        assert compile_cache_stats() == stats          # a repeated call adds nothing
    finally:
        obs.disable()


def test_build_all_starts_every_missing_source_at_once(fake_toolchain):
    from repro_torch import obs
    from repro_torch.kernels import _build

    tracer = obs.enable()
    try:
        with obs.span("warm", cat="test") as parent:
            built = _build.build_all(["page_minmax", "miniblock", "page_minmax"])
        assert built == ["page_minmax", "miniblock"]
        spans = tracer.spans("kernel.build")
        assert sorted(s["args"]["source"] for s in spans) == ["miniblock", "page_minmax"]
        assert all(s["args"]["parent_id"] == parent.span_id for s in spans)
        assert _counters()["builds"] == 2
        assert _build.build_all(["page_minmax", "miniblock"]) == []
        assert _counters()["builds"] == 2 and len(tracer.spans("kernel.build")) == 2
    finally:
        obs.disable()


def test_build_counts_nothing_while_tracing_is_off(fake_toolchain):
    from repro_torch import obs
    from repro_torch.kernels import _build

    obs.enable()
    obs.disable()
    before = _counters()
    _build.entry("page_minmax", "pmm_page_minmax", [], None)
    _build.entry("page_minmax", "pmm_page_minmax", [], None)
    assert _counters() == before and fake_toolchain == ["page_minmax"]


def test_cache_hits_from_many_threads_lose_no_count(fake_toolchain):
    """The scanner's worker threads launch at once: every cached lookup
    counts, under a short switch interval and more threads than cores."""
    import threading

    from repro_torch import obs
    from repro_torch.kernels import _build

    _build.entry("page_minmax", "pmm_page_minmax", [], None)
    n_threads, per_thread = 4 * (os.cpu_count() or 1), 200
    old = sys.getswitchinterval()
    obs.enable()
    try:
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=lambda: [
            _build.entry("page_minmax", "pmm_page_minmax", [], None)
            for _ in range(per_thread)]) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert _counters()["cache_hits"] == n_threads * per_thread
    finally:
        sys.setswitchinterval(old)
        obs.disable()
