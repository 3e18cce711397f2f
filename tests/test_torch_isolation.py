"""The port stands alone: no JAX, no ``ml_dtypes`` and nothing of the ``repro`` package.

A subprocess blocks both imports (``sys.modules[...] = None`` makes any
import of them raise), then imports the port, writes a file and reads it
back on the CPU, round-trips an array through the miniblock codec, writes a
sharded dataset and scans it, answers a query-server wave and draws one
data-feed batch over it, builds a reduced dense LM on the CPU, runs its
forward and serves two requests, runs the forward and loss of every config's
reduced variant (all six families), takes one backward under
``remat="full"`` (equal to ``"none"``'s), trains a reduced spatial-lm from the
lake with a compressed checkpoint and resumes from it (``ml_dtypes`` blocked
too: the port must run where it is not installed), checks that every entry point's
default device asks for a card, and runs the sharding slice: partition rules
on the production mesh shape, a sharded train step on a one-rank gloo group,
the roofline terms and the dry run's no-allocation input specs.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"

_CHILD = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.modules["ml_dtypes"] = None
import numpy as np, torch
import repro_torch
from repro_torch.core.columnar import from_ragged
from repro_torch.core.filters import Range
from repro_torch.core.reader import SpatialParquetReader
from repro_torch.core.writer import write_file
from repro_torch.data.synthetic import porto_taxi_like
import repro_torch.kernels.fp_delta, repro_torch.kernels.minmax, repro_torch.io, repro_torch.obs

cols = porto_taxi_like(n_traj=120)
n = cols.n_records
extra = {"d": np.arange(n, dtype=np.float32), "t": np.arange(n, dtype=np.int64)}
path = sys.argv[1]
write_file(path, columns=cols, extra=extra, extra_schema={"d": "<f4", "t": "<i8"},
           sort="hilbert", page_values=512, device="cpu")
bbox = (-8.7, 41.1, -8.6, 41.2)
with SpatialParquetReader(path) as r:
    dev = r.read_columnar(bbox=bbox, refine=True, device="cpu", filter=Range("d", 10.0, 90.0))
    host = r.read_columnar(bbox=bbox, refine=True, device="host", filter=Range("d", 10.0, 90.0))
    assert dev[2].records_returned == host[2].records_returned > 0
    assert np.array_equal(dev[0].x.view(np.int64), host[0].x.view(np.int64))
    if not torch.cuda.is_available():
        try:
            r.read_columnar(bbox=bbox, refine=True)
        except RuntimeError as e:
            assert "no CUDA device" in str(e)
        else:
            raise AssertionError("default device ran without a card")

from repro_torch.dataset import Catalog, Compactor, SpatialDatasetScanner, write_dataset
from repro_torch.kernels.fp_delta import compress_array, decompress_array, encode

x = (np.cumsum(np.random.default_rng(0).normal(0, 1e-3, 5000)) - 8.6).astype(np.float32)
buf = compress_array(x, device="cpu")
assert np.array_equal(decompress_array(buf, x.shape, device="cpu").view(np.int32), x.view(np.int32))
lake = sys.argv[2]
write_dataset(lake, columns=cols, extra=extra, sort="hilbert", n_shards=3, page_values=512,
              device="cpu")
sc = SpatialDatasetScanner(lake)
scans = [sc.scan(bbox=bbox, refine=True, device=d, filter=Range("d", 10.0, 90.0))
         for d in ("cpu", "host")]
for g, e, s in scans:
    assert s.records_returned == dev[2].records_returned and s.shards_total == 3
    assert np.array_equal(g.x.view(np.int64), dev[0].x.view(np.int64))
import repro_torch.baselines.geoparquet_like, repro_torch.baselines.shapefile, repro_torch.baselines.geojson_format
from repro_torch.data.pipeline import TrajectoryBatcher
from repro_torch.data.tokenizer import GeoTokenizer
from repro_torch.serve import SpatialQueryServer

with SpatialQueryServer(sc, device="cpu") as qsrv:
    q = qsrv.submit(bbox, filter=Range("d", 10.0, 90.0))
    qsrv.run()
assert q.stats.records_returned == dev[2].records_returned
assert np.array_equal(q.geo.x.view(np.int64), dev[0].x.view(np.int64))
tok = GeoTokenizer((-8.70, 41.10, -8.50, 41.25))
batch = next(iter(TrajectoryBatcher([lake], tok, seq_len=32, global_batch=4, bbox=bbox,
                                    device="cpu")))
assert batch["tokens"].shape == (1, 4, 32) and (batch["tokens"][..., 0] == 1).all()
if not torch.cuda.is_available():
    for call in (lambda: encode(x), lambda: compress_array(x),
                 lambda: decompress_array(buf, x.shape),
                 lambda: write_dataset(lake + "-2", columns=cols, n_shards=2),
                 lambda: sc.scan(bbox=bbox, refine=True),
                 lambda: Compactor(Catalog.open(lake)),
                 lambda: SpatialQueryServer(sc),
                 lambda: TrajectoryBatcher([lake], tok, seq_len=32, global_batch=4)):
        try:
            call()
        except RuntimeError as e:
            assert "no CUDA device" in str(e), e
        else:
            raise AssertionError("an entry point ran on its default device without a card")
    import os
    assert not os.path.exists(lake + "-2")

import dataclasses
import repro_torch.kernels.flash_attention
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve import BatchedServer

cfg = dataclasses.replace(get_config("qwen3-8b").reduced(), n_kv_heads=2, attn_impl="flash")
model = build_model(cfg)
params = model.init(0, device="cpu")
logits, _, _ = model.forward(params, {"tokens": np.arange(256, dtype=np.int32).reshape(2, 128)})
assert logits.shape == (2, 128, cfg.vocab) and bool(torch.isfinite(logits).all())
srv = BatchedServer(cfg, params, max_batch=2, max_len=32)
for n in (5, 9):
    srv.submit(np.arange(3, 3 + n), max_new_tokens=4)
served = srv.run()
assert sorted(len(r.out_tokens) for r in served) == [4, 4]
from repro_torch.configs import ARCHS
families = set()
for name in sorted(ARCHS):
    c = get_config(name).reduced()
    m = build_model(c)
    p = m.init(0, device="cpu")
    n_tok = 128 - c.vision_tokens if c.family == "vlm" else 128
    b = {"tokens": np.arange(2 * n_tok, dtype=np.int32).reshape(2, n_tok) % c.vocab}
    if c.family == "encdec":
        b["frames"] = np.ones((2, 64, c.frontend_dim), np.float32)
    if c.family == "vlm":
        b["patches"] = np.ones((2, c.vision_tokens, c.frontend_dim), np.float32)
    lg, aux, _ = m.forward(p, b)
    loss, _ = m.loss(p, b)
    assert lg.shape == (2, 128, c.vocab) and bool(torch.isfinite(lg).all()), name
    assert bool(torch.isfinite(loss)) and set(aux) <= {"moe_aux_loss", "router_z_loss"}, name
    families.add(c.family)
assert families == {"dense", "moe", "ssm", "hybrid", "encdec", "vlm"}, families
if not torch.cuda.is_available():
    try:
        model.init(0)
    except RuntimeError as e:
        assert "no CUDA device" in str(e)
    else:
        raise AssertionError("model init on the default device ran without a card")

# train a reduced spatial-lm from the lake, with a compressed checkpoint
# holding float32, int32 and bf16 leaves, and resume from it
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_loop import run_train_loop

lm = dataclasses.replace(get_config("spatial-lm").reduced(), vocab=tok.vocab,
                         opt_state_dtype="bfloat16")
feed = iter(TrajectoryBatcher([lake], tok, seq_len=64, global_batch=2, device="cpu"))
mgr = CheckpointManager(lake + "-ckpt", async_save=True, keep=2)
state, hist = run_train_loop(lm, OptConfig(lr=1e-3, warmup_steps=1, total_steps=4), feed,
                             global_batch=2, seq=64, steps=3, checkpoint_mgr=mgr,
                             checkpoint_every=2, log_every=1, device="cpu")
mgr.wait()
assert [h["step"] for h in hist] == [0, 1, 2] and mgr.latest_step() == 3
step, host = mgr.load_host()
assert host["opt_state"]["m"]["embed"].dtype == torch.bfloat16
assert torch.equal(host["params"]["embed"], state.params["embed"])
_, hist2 = run_train_loop(lm, OptConfig(lr=1e-3, warmup_steps=1, total_steps=4), feed,
                          global_batch=2, seq=64, steps=4, checkpoint_mgr=mgr,
                          checkpoint_every=2, log_every=1, device="cpu")
assert hist2[0]["step"] == 3
if not torch.cuda.is_available():
    try:
        mgr.restore_latest()
    except RuntimeError as e:
        assert "no CUDA device" in str(e)
    else:
        raise AssertionError("restore on the default device ran without a card")

# one backward under remat="full": each layer under torch.utils.checkpoint,
# recomputed in the backward, the same bits as without
from repro_torch.models import flatten_with_paths
from repro_torch.train.train_loop import value_and_grad

small = get_config("qwen3-8b").reduced()
p0 = build_model(small).init(0, device="cpu")
toks = {"tokens": np.arange(64, dtype=np.int32).reshape(2, 32) % small.vocab}
grads = {}
for remat in ("none", "full"):
    _, g = value_and_grad(build_model(dataclasses.replace(small, remat=remat)).loss)(p0, toks)
    grads[remat] = dict(flatten_with_paths(g))
assert all(torch.equal(grads["full"][k], grads["none"][k]) for k in grads["none"])

# the sharding slice: partition rules, meshes, a sharded step on a one-rank
# gloo group, the roofline tools and the dry run's no-allocation specs
import torch.distributed as dist
import repro_torch.sharding, repro_torch.launch.report
from repro_torch.configs import SHAPES
from repro_torch.launch.dryrun import input_specs
from repro_torch.launch.mesh import make_host_mesh, production_shape
from repro_torch.launch.roofline import count_params, model_flops, roofline_terms
from repro_torch.sharding import param_specs
from repro_torch.train.train_loop import make_train_step, mesh_layout, place
from repro_torch.train.optimizer import opt_init

q8 = get_config("qwen3-8b")
specs, notes = param_specs(q8, production_shape(), build_model(q8).init(0, device="meta"))
assert specs["layers"]["attn"]["wq"] == (None, "data", "model") and notes == []
assert roofline_terms(model_flops(q8, SHAPES["train_4k"]) / 256, 0.0, 0.0)["dominant"] == "compute"
assert input_specs(q8, SHAPES["decode_32k"])["cache"]["layers"]["k"].is_meta
dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
mesh = make_host_mesh(2, 2)                 # clamps to (1, 1) on one rank
assert tuple(mesh.shape) == (1, 1)
small = get_config("internlm2-1.8b").reduced()
oc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=4)
layout = mesh_layout(small, mesh, oc)
p0 = build_model(small).init(0, device="cpu")
step_fn, _ = make_train_step(small, oc, 2, 32, device="cpu", mesh=mesh)
_, _, met = step_fn(place(p0, mesh, layout.params), place(opt_init(oc, p0), mesh, layout.opt_state),
                    {"tokens": np.arange(64, dtype=np.int32).reshape(1, 2, 32) % small.vocab})
assert bool(torch.isfinite(met["loss"])) and count_params(small) > 0
dist.destroy_process_group()
assert not {"jax", "ml_dtypes"} & {m.split(".")[0] for m in sys.modules
                                   if sys.modules[m] is not None}
print("ISOLATED-OK", dev[2].records_returned)
"""


def test_port_runs_with_jax_and_repro_blocked(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _CHILD, str(tmp_path / "iso.spqf"),
                          str(tmp_path / "lake")],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ISOLATED-OK" in out.stdout


@pytest.mark.parametrize("root", ["src/repro_torch", "chip_smoke.py"])
def test_no_import_of_jax_or_repro(root):
    """Static check over every module of the port and the chip script."""
    base = Path(__file__).resolve().parents[1] / root
    files = [base] if base.is_file() else sorted(base.rglob("*.py"))
    assert files
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "repro", "ml_dtypes"), \
                    (f, name)
