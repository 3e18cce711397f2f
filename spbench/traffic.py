"""Traffic: what a mix file (``traffic/<mix>.json``) names, and the pieces
its query generators and drivers share.

A mix names two modules by file name, so that a mix of a new kind (another
box shape, a filter, another entry point or loop) is new files, never an
edit:

* ``"queries"``: ``spbench/queries/<name>.py``, whose ``make(mix, oracle,
  seed) -> (warm, sequence)`` draws the warm-up query and the window's
  sequence (replayed in a loop) from the seed and the mix's parameters;
* ``"driver"``: ``spbench/drivers/<name>.py``, which drives the program
  (``program(path, query, mix, device) -> (answer, bytes read)``), says
  what the reference expects of it (``reference(oracle, query, mix,
  precision) -> answer``) and runs the window (``window(call, queries,
  seconds) -> (logs, answers, window_s)``, as :func:`closed_loop` does).
"""

from __future__ import annotations

import importlib.util
import re
import time
import traceback
from dataclasses import dataclass
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = (5 ** 0.5 - 1) / 2
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclass(frozen=True)
class Query:
    bbox: tuple[float, float, float, float]
    target: float            # record selectivity asked for


@dataclass
class QueryLog:
    query: Query
    latency_s: float
    cpu_s: float
    pages_read: int = 0
    pages_total: int = 0
    bytes_read: int = 0
    records_scanned: int = 0
    records_returned: int = 0
    result_bytes: int = 0
    error: str | None = None
    ref_hit_pages: np.ndarray | None = None   # filled in by the check


def load_part(kind: str, name: str, root: Path = ROOT):
    """The module ``spbench/<kind>/<name>.py``, found by name under ``root``
    or, failing that, in this package's own checkout."""
    paths = [base / "spbench" / kind / f"{name}.py" for base in dict.fromkeys((root, ROOT))]
    path = next((p for p in paths if p.is_file()), None)
    if not NAME.match(name) or path is None:
        raise FileNotFoundError(f"no {kind} module {name!r} under {paths[0].parent}")
    mod_name = f"spbench_{kind}_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def targets(mix: dict) -> np.ndarray:
    """The middle of each of ``strata`` strata of the mix's selectivity range
    (``"spacing"``: ``"linear"`` or ``"log"``)."""
    lo, hi = (float(v) for v in mix["selectivity"])
    s = int(mix["strata"])
    if mix.get("spacing", "linear") == "log":
        edges = np.geomspace(lo, hi, s + 1)
        return np.sqrt(edges[:-1] * edges[1:])
    edges = np.linspace(lo, hi, s + 1)
    return (edges[:-1] + edges[1:]) / 2


def spread_order(ts: np.ndarray) -> np.ndarray:
    """``ts`` in one fixed order that spreads any prefix over the range (the
    strata sorted by the fractional part of ``i`` times the golden ratio:
    low, middle, high, ...), so every seed asks for the same sizes in the
    same order, whatever the window's length."""
    return ts[np.argsort((np.arange(len(ts)) * GOLDEN) % 1.0, kind="stable")]


def closed_loop(call, queries: list[Query], seconds: float):
    """One client: each query as soon as the last has answered, the
    sequence replayed, until ``seconds`` have passed (the last query ends
    after that, and its time counts). A query that raises is an answer that
    never comes: logged, and the loop goes on."""
    logs: list[QueryLog] = []
    answers = []
    w0 = time.perf_counter()
    deadline = w0 + seconds
    i = 0
    while True:
        q = queries[i % len(queries)]
        c0, t0 = time.process_time(), time.perf_counter()
        try:
            (ans, nread), err = call(q), None
        except Exception:
            ans, nread, err = None, 0, traceback.format_exc()
        t1 = time.perf_counter()
        logs.append(QueryLog(q, t1 - t0, time.process_time() - c0, bytes_read=nread,
                             error=err))
        answers.append(ans)
        i += 1
        if t1 >= deadline:
            return logs, answers, t1 - w0
