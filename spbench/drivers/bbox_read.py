"""A bbox read of every column: ``SpatialParquetReader(path)``, then
``read_columnar(bbox, refine=True)``, one client in a closed loop."""

from __future__ import annotations

from spbench.harness import program_answer
from spbench.traffic import closed_loop

window = closed_loop


def program(path, query, mix: dict, device: str):
    from repro_torch.core.reader import SpatialParquetReader

    with SpatialParquetReader(path) as r:
        res = r.read_columnar(query.bbox, refine=True, device=device)
    return program_answer(res), res[2].bytes_read


def reference(oracle, query, mix: dict, precision: str = "float64"):
    return oracle.expect(query.bbox, precision=precision)
