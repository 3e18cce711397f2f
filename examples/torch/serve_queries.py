"""Serving concurrent bbox queries with shared row-group decodes, on the
PyTorch/CUDA port (the twin of ``examples/serve_queries.py``).

Builds a small sharded Spatial Parquet lake, stands up a
:class:`~repro_torch.serve.query_scheduler.SpatialQueryServer`, and submits
a burst of overlapping bbox queries. The server groups the burst into one
admission wave, decodes each surviving row group **once** (on the card with
``--device cuda``), and answers every query out of the shared decode — then
a second identical burst is served entirely from the decoded-row-group
cache (compare-only work, no decode). Each query's results and ReadStats
are exactly what its solo ``scanner.scan(bbox, refine=True)`` would have
returned.

    PYTHONPATH=src python examples/torch/serve_queries.py [--device cuda|cpu|host]
"""

import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np

from repro_torch.data.synthetic import PORTO_BBOX, porto_taxi_like
from repro_torch.dataset import SpatialDatasetScanner, write_dataset
from repro_torch.serve.query_scheduler import SpatialQueryServer


def grid_boxes(n=4):
    x0, y0, x1, y1 = PORTO_BBOX
    xs = np.linspace(x0, x1, n + 1)
    ys = np.linspace(y0, y1, n + 1)
    return [(xs[i], ys[j], xs[i + 1], ys[j + 1])
            for i in range(n) for j in range(n)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu", "host"))
    args = ap.parse_args()
    write_device = "cpu" if args.device == "host" else args.device

    root = os.path.join(tempfile.mkdtemp(prefix="serve_lake_"), "pt")
    cols = porto_taxi_like(n_traj=4000, seed=0)
    write_dataset(root, columns=cols, n_shards=4, sort="hilbert",
                  page_values=8192, device=write_device)
    sc = SpatialDatasetScanner(root)

    boxes = grid_boxes(4) + [PORTO_BBOX]
    with SpatialQueryServer(sc, device=args.device, cache_rgs=64) as srv:
        t0 = time.perf_counter()
        queries = [srv.submit(b) for b in boxes]
        srv.run()
        cold = time.perf_counter() - t0
        for q in queries[:4]:
            n = q.geo.n_records if q.geo is not None else 0
            print(f"  query {q.qid}: {n:6d} trajectories, "
                  f"{q.stats.bytes_read:>9d} bytes attributed, "
                  f"{q.latency_s * 1e3:7.2f} ms")
        m = srv.metrics()
        print(f"cold burst: {len(boxes)} queries in {cold * 1e3:.1f} ms — "
              f"{m['rg_decodes']} row-group decodes for "
              f"{m['rg_touches']} touches "
              f"(shared-decode ratio {m['shared_decode_ratio']:.1f})")

        t0 = time.perf_counter()
        for b in boxes:
            srv.submit(b)
        srv.run()
        warm = time.perf_counter() - t0
        m = srv.metrics()
        print(f"warm burst: {warm * 1e3:.1f} ms — cache hits {m['cache_hits']}, "
              f"decodes still {m['rg_decodes']} (served from cache)")

    # the same queries, unshared, for comparison
    t0 = time.perf_counter()
    for b in boxes:
        sc.scan(bbox=b, refine=True, device=args.device, parallel=False)
    solo = time.perf_counter() - t0
    print(f"sequential solo scans: {solo * 1e3:.1f} ms")


if __name__ == "__main__":
    main()
