"""Quickstart on the PyTorch/CUDA port: write a Spatial Parquet file, read
it back, run range queries (the twin of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch/quickstart.py [--device cuda|cpu|host]

``--device cuda`` (the default) decodes the surviving FP-delta pages and
refines records on the card and raises without one; ``cpu`` runs the same
torch chain on CPU tensors; ``host`` is the numpy path.
"""

import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np

from repro_torch.core import (
    Geometry,
    SpatialParquetReader,
    SpatialParquetWriter,
)
from repro_torch.core.pages import best_codec


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu", "host"))
    args = ap.parse_args()
    # the writer reduces float32 zone stats on "cuda" or "cpu" (none here)
    write_device = "cpu" if args.device == "host" else args.device

    rng = np.random.default_rng(0)

    # 1. Build some geometries: a point-of-interest layer + a few polygons
    pois = [Geometry.point(*p) for p in rng.uniform(-10, 10, (50_000, 2))]
    shell = np.array([[0, 0], [0, 2], [2, 2], [2, 0], [0, 0]], float)
    parks = [Geometry.polygon(shell + rng.uniform(-10, 8, 2)) for _ in range(500)]

    path = os.path.join(tempfile.gettempdir(), "quickstart.spqf")

    # 2. Write: FP-delta encoding + Hilbert sort + zstd pages + timestamps
    with SpatialParquetWriter(
        path, encoding="fp_delta", codec=best_codec(), sort="hilbert",
        page_values=8192, extra_schema={"ts": "<i8"}, device=write_device,
    ) as w:
        w.write_geometries(pois, extra={"ts": np.arange(len(pois))})
        w.write_geometries(parks, extra={"ts": np.arange(len(parks))})
    print(f"wrote {path}: {os.path.getsize(path)/1e6:.2f} MB "
          f"({(len(pois)+5*len(parks))*16/1e6:.2f} MB of raw coordinates)")

    # 3. Read back with a range filter — the light-weight index prunes pages
    with SpatialParquetReader(path) as r:
        print(f"file holds {r.n_records} records, {len(r.index)} pages")
        query = (-2.0, -2.0, 2.0, 2.0)
        geoms, stats = r.read(bbox=query, refine=True, device=args.device)
        print(f"range query {query}: {len(geoms)} records, "
              f"read {stats.pages_read}/{stats.pages_total} pages "
              f"({stats.bytes_read/1e3:.0f} of {stats.bytes_total/1e3:.0f} KB)")

        # columnar fast path (no Geometry objects): raw coordinate arrays
        cols, extras, stats = r.read_columnar(bbox=query, device=args.device)
        print(f"columnar: {cols.n_values} coordinates, "
              f"ts column range {extras['ts'].min()}..{extras['ts'].max()}")

    os.unlink(path)


if __name__ == "__main__":
    main()
