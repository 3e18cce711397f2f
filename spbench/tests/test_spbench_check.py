"""A whole run on the CPU (the port's plain versions) against the reference,
and the comparison catching the control and each fault a bbox read can
have, planted underneath the timed path."""

import numpy as np
import pytest

from spbench import harness


@pytest.mark.parametrize("config,mix", [("porto-taxi", "bbox-large"),
                                        ("ebird-points", "bbox-large")])
@pytest.mark.parametrize("trace", [False, True])
def test_run_is_correct_on_the_cpu(tiny, config, mix, trace):
    out = harness.run_cell(tiny(config, mix), 2**31 + 9, 0.3, trace, device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    if not trace:
        assert {"setup_s", "bytes_per_point", "scan_mb_per_s"} <= set(out["metrics"])
    else:
        assert "host_cpu_s_per_gb.large" in out["metrics"]
        assert "transfer_share.large" in out["metrics"] and "write_mpts_per_s" in out["metrics"]


@pytest.mark.parametrize("config", ["porto-taxi", "ebird-points"])
def test_float32_control_is_not_correct(tiny, config):
    out = harness.run_cell(tiny(config, "bbox-large"), 41, 0.2, False, device="cpu",
                           control="float32")
    assert not out["correct"]
    assert out["checks"]["x_bits_off"]["value"] > 0


def _stale(monkeypatch):
    from repro_torch.core.reader import SpatialParquetReader

    orig, first = SpatialParquetReader.read_columnar, []

    def read_columnar(self, *a, **k):   # the state never moves on
        res = orig(self, *a, **k)
        first.append(res)
        return first[0]
    monkeypatch.setattr(SpatialParquetReader, "read_columnar", read_columnar)


def _half(monkeypatch):
    import repro_torch.kernels.fp_delta as fd

    orig = fd.decode_refine_stream

    def decode_refine_stream(*a, **k):  # half of the survivors left out
        res = orig(*a, **k)
        kept = np.flatnonzero(res.keep)
        res.keep[kept[::2]] = False
        return res
    monkeypatch.setattr(fd, "decode_refine_stream", decode_refine_stream)


def _flip(monkeypatch):
    import repro_torch.kernels.fp_delta as fd

    orig = fd.gather_stream_values

    def gather_stream_values(*a, **k):  # one coordinate bit altered where it is made
        out = orig(*a, **k)
        if len(out):
            out.view(np.int64)[0] ^= 1
        return out
    monkeypatch.setattr(fd, "gather_stream_values", gather_stream_values)


def _extra(monkeypatch):
    from repro_torch.core.reader import SpatialParquetReader

    orig = SpatialParquetReader._decode_run_extras

    def _decode_run_extras(self, src, extra_pages, extra_all, we, *a):
        orig(self, src, extra_pages, extra_all, we, *a)
        for v in extra_all.values():    # one extra column altered as it decodes
            v[we:].view(np.int64 if v.itemsize == 8 else np.int32)[:] ^= 1
            break
    monkeypatch.setattr(SpatialParquetReader, "_decode_run_extras", _decode_run_extras)


def _pages(monkeypatch):
    from repro_torch.core.index import SpatialIndex

    orig = SpatialIndex.query

    def query(self, *a, **k):           # the index keeps one page fewer
        return orig(self, *a, **k)[:-1]
    monkeypatch.setattr(SpatialIndex, "query", query)


@pytest.mark.parametrize("fault,check", [(_stale, "records_off"), (_half, "records_off"),
                                         (_flip, "x_bits_off"), (_extra, "extras_off"),
                                         (_pages, "pages_off")])
def test_a_fault_underneath_makes_the_run_not_correct(tiny, monkeypatch, fault, check):
    fault(monkeypatch)
    # large boxes: each target returns a different number of records
    out = harness.run_cell(tiny("porto-taxi", "bbox-large"), 43, 0.3, False, device="cpu")
    assert not out["correct"]
    assert out["checks"][check]["value"] > 0, out["checks"]
