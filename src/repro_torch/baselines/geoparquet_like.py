"""GeoParquet-like baseline (paper §5.1's strongest competitor).

Faithful to the paper's description of its Java GeoParquet implementation:
"five values per geometry object — one the WKB of the geometry, the other
four the minimum-bounding-rectangle for easy filtering". Column container
with raw (uncompressed) encodings + optional page-level gzip/zstd, page
min/max stats on the MBR columns for the same pruning semantics.

No FP-delta and no columnar coordinate exposure — that's precisely what the
paper's comparison isolates.
"""

from __future__ import annotations

import struct

import msgpack
import numpy as np

from repro_torch.core.columnar import assemble
from repro_torch.core.geometry import Geometry, bbox_intersects
from repro_torch.core.pages import compress, decompress

from .wkb import geometry_to_wkb, wkb_to_geometry

MAGIC = b"GPQL1\x00"


class GeoParquetLikeWriter:
    def __init__(self, path, *, codec: str = "none", page_records: int = 8192):
        self.path = str(path)
        self.codec = codec
        self.page_records = page_records
        self._fh = open(self.path, "wb")
        self._fh.write(MAGIC)
        self._offset = len(MAGIC)
        self._pages: list[dict] = []

    def write_geometries(self, geoms: list[Geometry]) -> None:
        for i in range(0, len(geoms), self.page_records):
            chunk = geoms[i : i + self.page_records]
            wkbs = [geometry_to_wkb(g) for g in chunk]
            lengths = np.array([len(w) for w in wkbs], np.uint32)
            boxes = np.array([g.bbox() for g in chunk], np.float64)  # (n, 4)
            payload = (
                struct.pack("<I", len(chunk))
                + lengths.astype("<u4").tobytes()
                + boxes.astype("<f8").tobytes()
                + b"".join(wkbs)
            )
            comp = compress(payload, self.codec)
            self._fh.write(comp)
            self._pages.append({
                "offset": self._offset,
                "nbytes": len(comp),
                "count": len(chunk),
                "bbox": [float(boxes[:, 0].min()), float(boxes[:, 1].min()),
                         float(boxes[:, 2].max()), float(boxes[:, 3].max())],
            })
            self._offset += len(comp)

    def write_columns(self, cols) -> None:
        self.write_geometries(assemble(cols))

    def close(self) -> dict:
        footer = {"codec": self.codec, "pages": self._pages,
                  "n_records": sum(p["count"] for p in self._pages)}
        blob = msgpack.packb(footer, use_bin_type=True)
        self._fh.write(blob)
        self._fh.write(struct.pack("<I", len(blob)))
        self._fh.write(MAGIC)
        self._fh.close()
        return footer

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class GeoParquetLikeReader:
    def __init__(self, path):
        self.path = str(path)
        self._fh = open(self.path, "rb")
        self._fh.seek(-(len(MAGIC) + 4), 2)
        (flen,) = struct.unpack("<I", self._fh.read(4))
        self._fh.seek(-(len(MAGIC) + 4 + flen), 2)
        self.footer = msgpack.unpackb(self._fh.read(flen), raw=False)
        self.codec = self.footer["codec"]

    def read(self, bbox=None, refine: bool = True):
        """Returns (geometries, pages_read, pages_total)."""
        out: list[Geometry] = []
        pages_read = 0
        for page in self.footer["pages"]:
            if bbox is not None and not bbox_intersects(
                (page["bbox"][0], page["bbox"][1], page["bbox"][2], page["bbox"][3]), bbox
            ):
                continue
            pages_read += 1
            self._fh.seek(page["offset"])
            payload = decompress(self._fh.read(page["nbytes"]), self.codec)
            (n,) = struct.unpack_from("<I", payload, 0)
            lengths = np.frombuffer(payload, "<u4", n, 4)
            boxes = np.frombuffer(payload, "<f8", n * 4, 4 + 4 * n).reshape(n, 4)
            off = 4 + 4 * n + 32 * n
            for i in range(n):
                if bbox is not None and refine and not bbox_intersects(boxes[i], bbox):
                    off += int(lengths[i])
                    continue
                g, off = wkb_to_geometry(payload, off)
                out.append(g)
        return out, pages_read, len(self.footer["pages"])

    def close(self):
        self._fh.close()
