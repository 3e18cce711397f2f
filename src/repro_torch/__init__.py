"""Spatial Parquet in PyTorch: the port of the ``repro`` package to CUDA.

The file format, writer and reader are the reference's; the device path
runs on hand-written CUDA kernels (``repro_torch/csrc``) on an NVIDIA
Hopper card. Entry points run on the card (``device="cuda"``) unless the
caller asks for the CPU (``device="cpu"``: the same torch chain with each
kernel's plain version) or, for reads and dataset scans, the numpy path
(``device="host"``)::

    from repro_torch import write_file, SpatialParquetReader

    write_file("trips.spqf", columns=cols, sort="hilbert")
    with SpatialParquetReader("trips.spqf") as r:
        geo, extras, stats = r.read_columnar(bbox=b, refine=True)

This package imports nothing from ``repro`` and nothing of JAX.
"""

from .core import (
    GeometryColumns,
    ReadStats,
    SpatialParquetReader,
    SpatialParquetWriter,
    TorchCoords,
    write_file,
)

__all__ = [
    "GeometryColumns",
    "ReadStats",
    "SpatialParquetReader",
    "SpatialParquetWriter",
    "TorchCoords",
    "write_file",
]
