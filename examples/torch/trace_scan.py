"""Trace a fused device scan on the PyTorch/CUDA port: where does a bbox
query spend its time? (The twin of ``examples/trace_scan.py``.)

    PYTHONPATH=src python examples/torch/trace_scan.py [--device cuda|cpu|host]

Writes a small sharded dataset, runs one traced fused decode→refine scan on
the card (``device="cuda"``, ``refine=True``), prints the per-stage
wall-clock breakdown and the metrics snapshot highlights, and emits
``scan_trace.json`` — open it in https://ui.perfetto.dev or
``chrome://tracing`` to see the shard fan-out, per-row-group fetch/plan/
launch spans and the ``device.*`` launch spans on a timeline. The untraced
warm-up scan builds (``nvcc``) or loads the kernels' libraries off the
clock: a ``kernel.build`` span shows where tracing is on during a first
launch, and the traced scan counts one ``kernel.cache_hits`` per entry-point
lookup. ``--device cpu`` runs the same torch chain on CPU tensors, ``host``
the numpy path.
"""

import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np

from repro_torch import obs
from repro_torch.core.columnar import from_ragged
from repro_torch.dataset import SpatialDatasetScanner, write_dataset


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu", "host"))
    args = ap.parse_args()
    write_device = "cpu" if args.device == "host" else args.device

    rng = np.random.default_rng(0)

    # 1. A small sharded lake: 40k points over 4 shards
    n = 40_000
    pts = np.round(rng.uniform(-100, 100, (n, 2)), 6)
    cols = from_ragged(np.ones(n, np.uint8), pts,
                       np.ones(n, np.int64), np.ones(n, np.int64))
    root = os.path.join(tempfile.mkdtemp(prefix="trace_scan_"), "lake")
    write_dataset(root, columns=cols, n_shards=4, sort="hilbert", device=write_device)
    sc = SpatialDatasetScanner(root, max_workers=4)
    bbox = (-50.0, -50.0, 50.0, 50.0)

    # 2. One untraced warm-up scan builds or loads the kernels off the
    #    clock, so the trace below shows steady-state stage costs
    sc.scan(bbox=bbox, refine=True, device=args.device)

    # 3. The traced scan: same query, same results, full attribution
    tracer = obs.enable()
    geo, _, stats = sc.scan(bbox=bbox, refine=True, device=args.device)
    obs.disable()
    print(f"scan: {stats.records_returned}/{stats.records_scanned} records, "
          f"{stats.bytes_read}/{stats.bytes_total} bytes read")

    # 4. Per-stage wall-clock breakdown (nested spans overlap their parents:
    #    this is attribution, not a partition of the total)
    print(f"\n{'stage':<22}{'count':>6}{'total ms':>11}{'max ms':>9}")
    for row in tracer.summary():
        print(f"{row['name']:<22}{row['count']:>6}"
              f"{row['total_ms']:>11.3f}{row['max_ms']:>9.3f}")

    # 5. Metrics snapshot highlights: latency percentiles + derived gauges
    snap = obs.snapshot()
    lat = snap["histograms"]["scan.dataset_latency_s"]
    print(f"\nscan latency: p50={lat['p50'] * 1e3:.2f}ms "
          f"p99={lat['p99'] * 1e3:.2f}ms over {lat['count']} scan(s)")
    print(f"host CPU per scanned GB: "
          f"{snap['gauges']['scan.host_cpu_s_per_gb']:.2f} s/GB")
    for level in ("shard", "page", "record"):
        print(f"bytes pruned at {level} level: "
              f"{snap['counters'].get(f'pruned.{level}_bytes', 0)}")
    c = snap["counters"]
    print(f"kernels: {c.get('kernel.builds', 0)} builds, {c.get('kernel.loads', 0)} loads, "
          f"{c.get('kernel.cache_hits', 0)} cache hits")

    # 6. Export for Perfetto / chrome://tracing
    out = tracer.export("scan_trace.json", metrics=snap)
    print(f"\nwrote {out} — open in https://ui.perfetto.dev")


if __name__ == "__main__":
    main()
