"""The port's dataset tier held against the JAX package's.

Each test runs the same steps through both packages, with inputs made by
each package's own ``porto_taxi_like`` from one seed (the port's copy is
held byte-identical) and extras made with numpy, and compares what a user
sees: shard files (byte-identical, in manifest order: names of later
generations carry a random token, so they are compared by position),
manifests (field by field, names aside), generations, orphans, and scan
results (coordinate bit patterns, extras, ``ReadStats``). The port scans on
``"cpu"`` (plain torch versions) and ``"host"`` (numpy); the reference on
``"cpu"`` (numpy) and ``"jax"`` (Pallas kernels in interpret mode). The
port writes on ``"cpu"``. Tolerance: exact.
"""

import dataclasses
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import repro.core.filters as jfilters  # noqa: E402
import repro.data.synthetic as jsynth  # noqa: E402
import repro.dataset as jds  # noqa: E402
import repro.io as jio  # noqa: E402
import repro.io.faults as jfaults  # noqa: E402
import repro_torch.core.filters as tfilters  # noqa: E402
import repro_torch.data.synthetic as tsynth  # noqa: E402
import repro_torch.dataset as tds  # noqa: E402
import repro_torch.io as tio  # noqa: E402
import repro_torch.io.faults as tfaults  # noqa: E402

REF = SimpleNamespace(name="jax", ds=jds, io=jio, faults=jfaults, filters=jfilters,
                      synth=jsynth, dev={}, scan_devices=("cpu", "jax"))
PORT = SimpleNamespace(name="torch", ds=tds, io=tio, faults=tfaults, filters=tfilters,
                       synth=tsynth, dev={"device": "cpu"}, scan_devices=("cpu", "host"))
SIDES = (REF, PORT)
WRITE_KW = dict(n_shards=4, sort="hilbert", page_values=512, row_group_records=2048)
BBOX = (-8.64, 41.14, -8.60, 41.17)


@pytest.fixture(autouse=True)
def _clean_crash_points():
    for side in SIDES:
        side.faults.disarm_crashes()
    yield
    for side in SIDES:
        side.faults.disarm_crashes()


def _data(side, seed=7, n_traj=200):
    cols = side.synth.porto_taxi_like(n_traj=n_traj, seed=seed)
    rng = np.random.default_rng(seed)
    n = cols.n_records
    return cols, {"tid": np.arange(n, dtype=np.int64),
                  "dur": rng.normal(600, 300, n).astype(np.float32)}


def _write(side, root, seed=7, n_traj=200, **kw):
    cols, extra = _data(side, seed, n_traj)
    return side.ds.write_dataset(root, columns=cols, extra=extra,
                                 **{**WRITE_KW, **side.dev, **kw})


def _norm(name: str) -> str:
    """A file name with its random parts (transaction token, temp suffix) blanked."""
    name = re.sub(r"-[0-9a-f]{8}-", "-<token>-", name)
    return re.sub(r"\.tmp-.*$", ".tmp-<rand>", name)


def _manifest_state(manifest) -> dict:
    d = manifest.to_dict()
    for s in d["shards"]:
        s["path"] = _norm(s["path"])
    return d


def _files_state(root, manifest) -> list[bytes]:
    return [open(os.path.join(root, s.path), "rb").read() for s in manifest.shards]


def _scan_state(res) -> tuple:
    """Coordinates and levels as bit patterns, extras, and ReadStats (failure
    records without their directory-dependent path and message)."""
    geo, extras, stats = res
    g = None
    if geo is not None:
        geo = geo.coords_to_host()
        g = {f: np.asarray(getattr(geo, f)).tobytes()
             for f in ("types", "type_rep", "rep", "defn", "x", "y")}
    st = dataclasses.asdict(stats)
    st["failures"] = [(f["shard_index"], f["error_type"], f["attempts"])
                      for f in st["failures"]]
    return g, {k: np.asarray(v).tobytes() for k, v in sorted(extras.items())}, st


def _scans(side, scanner, **kw) -> list[tuple]:
    devs = side.scan_devices
    if kw.get("keep_on_device"):
        devs = devs[1:] if side is REF else devs[:1]
    return [_scan_state(scanner.scan(device=d, **kw)) for d in devs]


def _both(fn, tmp_path):
    """Run ``fn(side, root)`` for both packages; return (reference, port)."""
    return tuple(fn(side, str(tmp_path / side.name)) for side in SIDES)


# ------------------------------------------------------------------ writes
@pytest.fixture(scope="module")
def lakes(tmp_path_factory):
    base = tmp_path_factory.mktemp("lakes")
    roots = {side.name: str(base / side.name) for side in SIDES}
    manifests = {side.name: _write(side, roots[side.name], n_traj=300) for side in SIDES}
    return roots, manifests


def test_write_dataset_matches_reference(lakes):
    roots, manifests = lakes
    mj, mt = manifests["jax"], manifests["torch"]
    assert _manifest_state(mj) == _manifest_state(mt)
    assert mj.n_shards == 4 and all(s.zone_maps for s in mt.shards)
    assert _files_state(roots["jax"], mj) == _files_state(roots["torch"], mt)
    for side in SIDES:
        cat = side.ds.Catalog.open(roots[side.name])
        assert cat.head_generation() == 1


SCAN_CASES = {
    "full": dict(),
    "bbox_refine": dict(bbox=BBOX, refine=True),
    "bbox_sequential": dict(bbox=BBOX, refine=False, parallel=False),
    "filter": dict(bbox=BBOX, refine=True, filter=("dur", 300.0, 900.0)),
    "filter_only": dict(filter=("dur", 900.0, None)),
    "keep_on_device": dict(bbox=BBOX, refine=True, keep_on_device=True),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_scan_matches_reference(lakes, case):
    roots, _ = lakes
    states = []
    for side in SIDES:
        kw = dict(SCAN_CASES[case])
        if "filter" in kw:
            kw["filter"] = side.filters.Range(*kw["filter"])
        sc = side.ds.SpatialDatasetScanner(roots[side.name], max_workers=3)
        states += _scans(side, sc, **kw)
    assert all(s == states[0] for s in states[1:])
    assert states[0][2]["records_returned"] > 0


def test_scan_device_names(lakes):
    roots, _ = lakes
    sc = tds.SpatialDatasetScanner(roots["torch"])
    with pytest.raises(ValueError, match="device must be"):
        sc.scan(device="jax")
    with pytest.raises(ValueError, match="keep_on_device"):
        sc.scan(device="host", keep_on_device=True)


# ----------------------------------------------------------------- catalog
def test_commit_conflict_matches_reference(tmp_path):
    def run(side, root):
        _write(side, root)
        cat = side.ds.Catalog.open(root)
        tx = cat.begin()
        side.ds.Catalog.open(root).commit_manifest(cat.head_snapshot().manifest)
        with pytest.raises(side.ds.CommitConflict):
            tx.commit(cat.load_snapshot(1).manifest)
        cat2 = side.ds.Catalog.open(root)
        return (cat2.head_generation(), sorted(map(_norm, os.listdir(root))),
                _manifest_state(cat2.head_snapshot().manifest))

    ref, port = _both(run, tmp_path)
    assert ref == port and ref[0] == 2


def test_pin_blocks_gc_matches_reference(tmp_path):
    def run(side, root):
        _write(side, root)
        cat = side.ds.Catalog.open(root, keep_snapshots=1)
        pin = cat.pin()
        state = [sorted(side.ds.pinned_generations(root))]
        comp = side.ds.Compactor(cat, target_records=1 << 30, page_values=512,
                                 row_group_records=2048, **side.dev)
        state.append(comp.run_once().generation)
        old = [s.path for s in cat.load_snapshot(1).manifest.shards]
        state.append([os.path.isfile(os.path.join(root, p)) for p in old])
        state.append(os.path.isfile(os.path.join(root, "snap-0000000001.json")))
        pin.release()
        state.append(sorted(map(_norm, cat.gc()["deleted"])))
        state.append([os.path.exists(os.path.join(root, p)) for p in old])
        return state

    ref, port = _both(run, tmp_path)
    assert ref == port
    assert ref[2] == [True] * 4 and ref[5] == [False] * 4


def test_compaction_matches_reference(tmp_path):
    def run(side, root):
        _write(side, root, n_traj=300, n_shards=6)
        sc = side.ds.SpatialDatasetScanner(root)
        before = [_scan_state(sc.scan(bbox=b, refine=b is not None, device=side.scan_devices[0]))
                  for b in (None, BBOX)]
        cat = side.ds.Catalog.open(root)
        per = cat.head_snapshot().manifest.shards[0].n_records
        comp = side.ds.Compactor(cat, target_records=per * 2, page_values=512,
                                 row_group_records=2048, **side.dev)
        snap = comp.run_once()
        fresh = side.ds.SpatialDatasetScanner(root)
        after = [_scan_state(fresh.scan(bbox=b, refine=b is not None, device=d))
                 for b in (None, BBOX) for d in side.scan_devices]
        return (snap.generation, _manifest_state(snap.manifest),
                _files_state(root, snap.manifest), before, after, comp.run_once())

    ref, port = _both(run, tmp_path)
    assert ref[:4] == port[:4] and ref[5] is None and port[5] is None
    assert ref[1]["shards"] and len(ref[1]["shards"]) == 3
    # every scan after compaction returns what the scan before it returned
    # (ReadStats differ: fewer shards, other pages), in both packages
    for state in (ref, port):
        assert [a[:2] for a in state[4]] == [state[3][0][:2]] * 2 + [state[3][1][:2]] * 2
    assert ref[4] == port[4]


def _crash_run(side, root, point):
    """One crash at ``point``, then what a reopening user sees, then recovery."""
    faults = side.faults
    _write(side, root)
    scan = lambda: _scan_state(side.ds.SpatialDatasetScanner(root).scan(  # noqa: E731
        device=side.scan_devices[0]))
    state = [scan()]
    if point == faults.CRASH_GC_MID:
        cat = side.ds.Catalog.open(root, keep_snapshots=1, auto_gc=False)
        cat.commit_manifest(cat.head_snapshot().manifest, gc=False)
        state.append(sorted(map(_norm, cat.orphans())))
        faults.arm_crash(point)
        with pytest.raises(faults.InjectedCrash):
            cat.gc()
        faults.disarm_crashes()
    elif point == faults.CRASH_COMPACT_MID:
        cat = side.ds.Catalog.open(root)
        per = cat.head_snapshot().manifest.shards[0].n_records
        comp = side.ds.Compactor(cat, target_records=per * 2, page_values=512,
                                 row_group_records=2048, **side.dev)
        with faults.crash_injection(point) as ci:
            comp.run_once()
        assert ci.crashed
    else:
        kw = {"truncate_frac": 0.5} if point == faults.CRASH_SHARD_TORN else {}
        with faults.crash_injection(point, **kw) as ci:
            _write(side, root, seed=9, n_traj=150)
        assert ci.crashed
    cat = side.ds.Catalog.open(root, keep_snapshots=1)
    state += [cat.head_generation(), scan(), sorted(map(_norm, cat.orphans()))]
    state.append(sorted(map(_norm, cat.gc()["deleted"])))
    state.append(cat.orphans())
    # recovery: the interrupted operation runs to its end
    if point == faults.CRASH_COMPACT_MID:
        state.append(comp.run_once().generation)
    elif point != faults.CRASH_GC_MID:
        state.append(_write(side, root, seed=9, n_traj=150).n_shards)
    cat = side.ds.Catalog.open(root)
    state += [cat.head_generation(), scan(), sorted(map(_norm, os.listdir(root)))]
    return state


@pytest.mark.parametrize("point", ["CRASH_SHARD_TORN", "CRASH_COMMIT_PRE_RENAME",
                                   "CRASH_COMMIT_POST_RENAME", "CRASH_COMPACT_MID",
                                   "CRASH_GC_MID"])
def test_crash_recovery_matches_reference(tmp_path, point):
    assert set(jfaults.CRASH_POINTS) == set(tfaults.CRASH_POINTS)
    ref, port = (_crash_run(side, str(tmp_path / side.name), getattr(side.faults, point))
                 for side in SIDES)
    assert ref == port


def test_skip_scan_over_faulty_remote_matches_reference(tmp_path):
    def run(side, root):
        manifest = _write(side, root)
        bad = manifest.shards[1].path
        io = side.io

        def factory(path):
            faults = [io.FaultSpec(io.FAULT_ERROR, times=None)] if path.endswith(bad) else []
            return io.RemoteRangeSource(io.InProcessRangeServer(path, faults=faults),
                                        max_retries=0, backoff_base=0.0, backoff_max=0.0)

        sc = side.ds.SpatialDatasetScanner(root, on_error="skip", shard_retries=1,
                                           source_factory=factory)
        states = []
        for d in side.scan_devices:
            states += [_scan_state(sc.scan(device=d)),
                       _scan_state(sc.scan(bbox=BBOX, refine=True, device=d))]
        return states

    ref, port = _both(run, tmp_path)
    assert all(s == ref[0] for s in ref[::2] + port[::2])
    assert all(s == ref[1] for s in ref[1::2] + port[1::2])
    assert ref[0][2]["failures"] == [(1, "RetriesExhausted", 2)]
