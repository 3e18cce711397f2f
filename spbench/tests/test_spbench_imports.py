"""Nothing under spbench/ imports jax or the JAX package; the reference
imports nothing of the port either."""

import ast
import os
import subprocess
import sys
from pathlib import Path

SPBENCH = Path(__file__).resolve().parents[1]
ROOT = SPBENCH.parent
BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(SPBENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        bad = top_level_imports(f) & BANNED
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"


def test_reference_imports_nothing_of_the_port():
    files = sorted((SPBENCH / "reference").rglob("*.py"))
    for f in files:
        names = top_level_imports(f)
        assert names <= {"__future__", "dataclasses", "functools", "numpy"}, (f, names)


def test_names_are_compared_whole():
    from spbench import harness

    fakes = ["repro_torch_probe", "jaxtyping_probe", "repro.probe_x", "jax_probe.sub"]
    for name in fakes:
        sys.modules[name] = type(sys)(name)
    try:
        found = harness.forbidden_modules()
        assert "repro.probe_x" in found
        assert not {"repro_torch_probe", "jaxtyping_probe", "jax_probe.sub"} & set(found)
    finally:
        for name in fakes:
            del sys.modules[name]


def test_a_run_loads_no_jax(tmp_path):
    """A whole run (the CPU path) in a fresh process leaves no jax, jaxlib,
    flax or repro module behind."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from spbench.tests.conftest import tiny_cell\n"
        "from spbench import harness\n"
        "out = harness.run_cell(tiny_cell('porto-taxi', 'bbox-large'), 3, 0.2, True, device='cpu')\n"
        "assert out['correct'], out\n"
        "print('FOUND', harness.forbidden_modules())\n" % (str(ROOT), str(ROOT / "src")))
    env = dict(os.environ, TMPDIR=str(tmp_path))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       cwd=str(tmp_path), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "FOUND []" in r.stdout
