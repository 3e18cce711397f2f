#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, from the root of a checkout.

    python3 spbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` and, traced, ``breakdown``;
``checks`` (every number compared, with its limit) comes last. The same
numbers are the last lines on standard error. Exits non-zero, printing no
result, without a CUDA card (or fewer than the cell asks for), without the
port's package beside this directory, or if ``jax``, ``jaxlib``, ``flax``
or the JAX package were loaded by the end of the window.

``--control float32`` runs the control of the check instead of the
program: the plain reference computed in float32, which must come out not
correct. The benchmark's own runs never pass it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from spbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("float32",), default=None)
    args = ap.parse_args(argv)
    harness.kernel_cache_env()
    try:
        cell = harness.load_cell(args.workload)
        harness.import_program()
    except (OSError, KeyError, ValueError) as e:
        print(f"spbench: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"spbench: {cell.name} needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device="cuda",
                           t_start=T_START, control=args.control)
    found = harness.forbidden_modules()
    if found:
        print(f"spbench: the process loaded {found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
