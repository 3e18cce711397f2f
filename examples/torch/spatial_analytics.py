"""Spatial analytics over a sharded Spatial Parquet data lake, on the
PyTorch/CUDA port (the twin of ``examples/spatial_analytics.py``).

Writes the dataset analogs as *sharded datasets* (SFC-partitioned shards +
JSON manifest, ``repro_torch.dataset``), then answers analytical queries
with the two-level index — shard MBR pruning first, per-page [min,max]
pruning inside each surviving shard — and the async fan-out scanner, each
surviving page decoded and each record refined on the card with
``--device cuda``:

  1. count points per region (shard + page pruned range scans),
  2. average trajectory length in a city bbox (needs only x/y + levels),
  3. densest hotspot among sampled query cells,
  4. bytes touched per query vs the whole lake (the Figure 11 story, live).

    PYTHONPATH=src python examples/torch/spatial_analytics.py [--device cuda|cpu|host]
"""

import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np

from repro_torch.core.pages import best_codec
from repro_torch.data.synthetic import PORTO_BBOX, US_BBOX, ebird_like, porto_taxi_like
from repro_torch.dataset import SpatialDatasetScanner, write_dataset


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu", "host"))
    args = ap.parse_args()
    device = args.device
    write_device = "cpu" if device == "host" else device

    lake = tempfile.mkdtemp(prefix="lake_")

    pt = porto_taxi_like(n_traj=4000, seed=0)
    eb = ebird_like(n_points=200_000, seed=1)
    scanners = {}
    for name, cols, shards in (("porto", pt, 4), ("ebird", eb, 8)):
        root = os.path.join(lake, name)
        m = write_dataset(root, columns=cols, n_shards=shards, sort="hilbert",
                          codec=best_codec(), page_values=8192, device=write_device)
        total_mb = sum(s.file_bytes for s in m.shards) / 1e6
        scanners[name] = SpatialDatasetScanner(root, max_workers=4)
        print(f"[lake] {name}: {cols.n_values} pts -> {m.n_shards} shards, "
              f"{total_mb:.2f} MB")

    # --- 1. regional counts with shard + page pruning
    sc = scanners["ebird"]
    quads = {
        "NW": (US_BBOX[0], (US_BBOX[1]+US_BBOX[3])/2, (US_BBOX[0]+US_BBOX[2])/2, US_BBOX[3]),
        "SE": ((US_BBOX[0]+US_BBOX[2])/2, US_BBOX[1], US_BBOX[2], (US_BBOX[1]+US_BBOX[3])/2),
    }
    for qname, q in quads.items():
        t0 = time.time()
        cols, _, st = sc.scan(bbox=q, refine=True, device=device)
        n = cols.n_records if cols else 0
        print(f"[q1] ebird {qname}: {n} observations "
              f"(shards {st.shards_read}/{st.shards_total}, "
              f"pages {st.pages_read}/{st.pages_total}, "
              f"{1e3*(time.time()-t0):.0f}ms)")

    # --- 2. average trajectory length in central Porto
    sc = scanners["porto"]
    cy = (PORTO_BBOX[1] + PORTO_BBOX[3]) / 2
    q = central_porto_box()
    cols, _, st = sc.scan(bbox=q, refine=True, device=device)
    if cols is not None and cols.n_records:
        starts = cols.record_value_starts()
        counts = np.diff(np.append(starts, cols.n_values))
        # haversine-ish path length (flat-earth at city scale)
        dx = np.diff(cols.x) * 111e3 * np.cos(np.radians(cy))
        dy = np.diff(cols.y) * 111e3
        seg = np.sqrt(dx**2 + dy**2)
        seg[np.cumsum(counts)[:-1] - 1] = 0  # cut segments across records
        print(f"[q2] central Porto: {cols.n_records} trajectories, "
              f"mean {counts.mean():.1f} pts, mean path {seg.sum()/cols.n_records:.0f} m "
              f"(shards {st.shards_read}/{st.shards_total}, "
              f"pages {st.pages_read}/{st.pages_total})")

    # --- 3. densest cell among sampled candidates
    sc = scanners["ebird"]
    rng = np.random.default_rng(0)
    best = (None, -1)
    bytes_frac = []
    for _ in range(12):
        x0 = rng.uniform(US_BBOX[0], US_BBOX[2] - 1)
        y0 = rng.uniform(US_BBOX[1], US_BBOX[3] - 1)
        q = (x0, y0, x0 + 1.0, y0 + 1.0)
        cols, _, st = sc.scan(bbox=q, refine=True, device=device)
        n = cols.n_records if cols else 0
        bytes_frac.append(st.bytes_read / st.bytes_total)
        if n > best[1]:
            best = (q, n)
    print(f"[q3] densest of 12 sampled 1-degree cells: {best[1]} obs at "
          f"({best[0][0]:.2f},{best[0][1]:.2f}); mean bytes touched/query "
          f"{100*np.mean(bytes_frac):.1f}% of the lake")

    # --- 4. pruning report: bytes touched vs the whole lake (stats already
    # carry the lake-wide denominator; no full scan needed)
    for name, q in (("porto", central_porto_box()),
                    ("ebird", (US_BBOX[0], US_BBOX[1],
                               US_BBOX[0]+4, US_BBOX[1]+4))):
        _, _, st = scanners[name].scan(bbox=q, device=device)
        print(f"[q4] {name}: bbox query reads {st.bytes_read/1e3:.0f} kB of "
              f"{st.bytes_total/1e3:.0f} kB "
              f"({100*st.bytes_read/max(st.bytes_total,1):.1f}%, "
              f"shards {st.shards_read}/{st.shards_total})")

    print(f"[done] lake at {lake}")


def central_porto_box():
    cx = (PORTO_BBOX[0] + PORTO_BBOX[2]) / 2
    cy = (PORTO_BBOX[1] + PORTO_BBOX[3]) / 2
    return (cx - 0.03, cy - 0.03, cx + 0.03, cy + 0.03)


if __name__ == "__main__":
    main()
