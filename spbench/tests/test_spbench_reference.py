"""The plain reference against the port at small sizes: its frozen
generators, Hilbert keys, file order and page layout."""

import numpy as np
import pytest

from spbench.reference.oracle import Oracle, stable_argsort
from spbench.reference.ragged import bits
from spbench.reference.sfc import hilbert_sort_keys
from spbench import harness

from .conftest import TINY_WRITER, tiny_cell


@pytest.mark.parametrize("config,port_gen,sizes,kw", [
    ("porto-taxi", "porto_taxi_like", {"n_traj": 700}, {"n_traj": 700}),
    ("ebird-points", "ebird_like", {"n_points": 3000}, {"n_points": 3000}),
])
def test_frozen_generators_equal_the_repository_generators(config, port_gen, sizes, kw):
    from repro_torch.data import synthetic

    cell = tiny_cell(config, "bbox-large")
    cell.config["sizes"].update(sizes)
    data, _, _ = harness.make_data(cell.config, 17)
    port = getattr(synthetic, port_gen)(seed=17, **kw)
    assert np.array_equal(bits(data.coords[:, 0]), bits(port.x))
    assert np.array_equal(bits(data.coords[:, 1]), bits(port.y))
    starts = port.record_value_starts()
    assert np.array_equal(data.values_per_record(), np.diff(np.append(starts, port.n_values)))


@pytest.mark.parametrize("order", [16, 7, 3])
def test_hilbert_keys_equal_the_writer_keys(order):
    from repro_torch.core.sfc import sort_keys

    rng = np.random.default_rng(order)
    cx = np.round(rng.normal(0, 1, 50_000), 2)   # rounded: many ties
    cy = np.round(rng.normal(0, 1, 50_000), 2)
    keys = hilbert_sort_keys(cx, cy, order)
    assert np.array_equal(keys, sort_keys(cx, cy, "hilbert", order))
    assert np.array_equal(stable_argsort(keys, 2 * order), np.argsort(keys, kind="stable"))


@pytest.mark.parametrize("config", ["porto-taxi", "ebird-points"])
def test_file_order_and_pages_equal_what_the_writer_wrote(config, tmp_path):
    from repro_torch.core.columnar import from_ragged
    from repro_torch.core.reader import SpatialParquetReader
    from repro_torch.core.writer import write_file

    cell = tiny_cell(config, "bbox-large")
    data, extras, schema = harness.make_data(cell.config, 23)
    path = tmp_path / "f.spqf"
    write_file(path, columns=from_ragged(data.types, data.coords, data.part_sizes,
                                         data.parts_per_record),
               extra=extras, extra_schema=schema, device="cpu", **cell.config["writer"])
    oracle = Oracle(data, extras, cell.config["writer"])
    with SpatialParquetReader(path) as r:
        idx = r.index
        geo, ex, _ = r.read_columnar(device="host")
    rg_start = np.concatenate([[0], np.cumsum([TINY_WRITER["row_group_records"]] * 99)])
    assert np.array_equal(rg_start[idx.row_group] + idx.rec_start, oracle.page_start)
    assert np.array_equal(idx.rec_count, oracle.page_records)
    want = oracle.expect((-1e9, -1e9, 1e9, 1e9))
    assert np.array_equal(bits(geo.x), want.x) and np.array_equal(geo.rep, want.rep)
    for k in extras:
        assert np.array_equal(bits(ex[k]), want.extras[k])


def test_float32_control_differs_from_the_reference():
    cell = tiny_cell("porto-taxi", "bbox-large")
    data, extras, _ = harness.make_data(cell.config, 29)
    oracle = Oracle(data, extras, cell.config["writer"])
    box = (-8.66, 41.12, -8.58, 41.2)
    a, b = oracle.expect(box), oracle.expect(box, precision="float32")
    assert a.n > 100 and np.count_nonzero(a.x[: min(len(a.x), len(b.x))]
                                           != b.x[: min(len(a.x), len(b.x))]) > 0
