"""Spatial Parquet core, PyTorch port: the paper's contribution as a composable library.

Public API::

    from repro_torch.core import (
        Geometry, GeometryColumns, shred, assemble, from_ragged,
        fp_delta_encode, fp_delta_decode, compute_best_delta_bits,
        SpatialParquetWriter, SpatialParquetReader, SpatialIndex, write_file,
    )
"""

from .columnar import GeometryColumns, TorchCoords, assemble, from_ragged, shred
from .filters import (
    And,
    In,
    IsNull,
    Predicate,
    Range,
    canonical_bbox,
    validate_predicate,
)
from .fp_delta import (
    FPDeltaStats,
    compute_best_delta_bits,
    delta_bit_histogram,
    fp_delta_decode,
    fp_delta_encode,
    fp_delta_encode_pages,
)
from .pages import CodecUnavailable, have_codec
from .geometry import (
    TYPE_EMPTY,
    TYPE_GEOMETRYCOLLECTION,
    TYPE_LINESTRING,
    TYPE_MULTILINESTRING,
    TYPE_MULTIPOINT,
    TYPE_MULTIPOLYGON,
    TYPE_POINT,
    TYPE_POLYGON,
    Geometry,
    bbox_intersects,
)
from .index import SpatialIndex
from .reader import ReadStats, SpatialParquetReader
from .sfc import hilbert_key, sort_keys, z_key
from .writer import SpatialParquetWriter, permute_records, record_centroids, write_file

__all__ = [
    "Geometry",
    "GeometryColumns",
    "TorchCoords",
    "shred",
    "assemble",
    "from_ragged",
    "fp_delta_encode",
    "fp_delta_decode",
    "fp_delta_encode_pages",
    "compute_best_delta_bits",
    "CodecUnavailable",
    "have_codec",
    "delta_bit_histogram",
    "FPDeltaStats",
    "SpatialParquetWriter",
    "SpatialParquetReader",
    "SpatialIndex",
    "ReadStats",
    "Predicate",
    "Range",
    "In",
    "IsNull",
    "And",
    "canonical_bbox",
    "validate_predicate",
    "write_file",
    "permute_records",
    "record_centroids",
    "sort_keys",
    "hilbert_key",
    "z_key",
    "bbox_intersects",
    "TYPE_EMPTY",
    "TYPE_POINT",
    "TYPE_LINESTRING",
    "TYPE_POLYGON",
    "TYPE_MULTIPOINT",
    "TYPE_MULTILINESTRING",
    "TYPE_MULTIPOLYGON",
    "TYPE_GEOMETRYCOLLECTION",
]
