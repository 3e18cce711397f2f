"""The mesh faults of the port's sharded steps, repaired, on the CPU.

Three kinds of step raised inside DTensor's sharding propagation:

* heads that do not divide 'model' (minicpm3's 40, arctic's 56 at 16): the
  backward of a head merge, ``out.reshape(b, s, h * hd)`` ahead of the
  row-parallel ``wo``, got its gradient sharded over 'model' on the flat
  dim, which it cannot unflatten into the heads (``merge_ready``);
* the sequence put on 'model' (mamba2, zamba2, whisper): a mean over the
  SSM's model-sharded gated norm left a pending partial mean that DTensor
  resolved by scattering it over the sequence, and the per-rank attention
  handed back permuted local gradients that DTensor then viewed as if they
  were contiguous; a weight-gradient product over the (B·S, C) flatten of
  such a tensor reads a host value and fails;
* MLA decode over a latent cache sharded on its sequence (minicpm3
  ``decode_32k``): the expansion ``c_kv @ wkv_b`` multiplied a
  sequence-sharded latent by a weight sharded on its output.

(a) Small dry runs on a fake process group (``run_cell`` as in
``tests/test_torch_roofline.py``): each step traces on (1, 4) and (2, 4) at
the same global batch, and on (2, 4) every rank counts at most 0.6x the
FLOPs of (1, 4): doubling the 'data' ranks halves each rank's rows, where
a rank that gathered the batch would count about as many.

(b) Real 4-process gloo meshes of shape (1, 4), each held against one
device in rank 0's own process as ``tests/test_torch_distributed.py``
holds its train step (loss and ``grad_norm`` within 1e-5 relative, the
moments within 1e-5 of their leaf's largest magnitude, each parameter
within what its moments imply), and MLA decode over a sequence-sharded
latent cache, whose greedy tokens equal one device's exactly. Reduced
qwen3 with 4 query and 2 kv heads trains too: its query heads divide
'model' and its kv heads do not, so each rank's kv gradient is a partial
sum over 'model' (the per-rank attention once declared it whole). Reduced
qwen3 and qwen2-moe train again under ``remat="full"`` (the shipped
configs' mode; reduced configs set ``"none"``), each layer recomputed with
its collectives in the backward.
"""

import datetime
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from test_torch_distributed import (RENDEZVOUS, RUN_TIMEOUT, TOL, _compare_after_step, _env,
                                    _whole)

SRC = str(Path(__file__).resolve().parents[1] / "src")

# (arch, config changes, global batch) of each reduced train repro
TRAIN = [
    ("mamba2-130m", {}, 4),
    ("whisper-medium", {}, 4),
    ("zamba2-1.2b", {}, 4),
    ("minicpm3-4b", {"n_heads": 6}, 8),
    ("arctic-480b", {"n_heads": 6, "n_kv_heads": 2}, 8),
]


# ------------------------------------------------------- (a) fake-group runs
_DRYRUN = """
import dataclasses, json, sys
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch.dryrun import fake_group, run_cell
from repro_torch.launch.mesh import MeshShape

arch, kind, batch = sys.argv[1], sys.argv[2], int(sys.argv[3])
cfg = dataclasses.replace(get_config(arch).reduced(), **json.loads(sys.argv[4]))
shape = ShapeConfig("tiny_" + kind, 64, batch, kind)
out = {}
for mesh in ((1, 4), (2, 4)):
    with fake_group(mesh[0] * mesh[1]):
        rec = run_cell(arch, shape.name, multi_pod=False, cfg=cfg, shape=shape,
                       mesh_shape=MeshShape(("data", "model"), mesh), counting="direct")
    out["x".join(map(str, mesh))] = {"status": rec["status"], "chips": rec["chips"],
                                     "flops": rec["cost_raw"]["flops"]}
print("RESULT", json.dumps(out))
"""


def _dry_run(arch, kind, batch, changes) -> dict:
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_DRYRUN), arch, kind, str(batch),
                        json.dumps(changes)], capture_output=True, text=True, env=env,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.split("RESULT ", 1)[1])


def _assert_traced_and_split(rec):
    assert rec["1x4"]["status"] == "ok" and rec["2x4"]["status"] == "ok", rec
    assert rec["1x4"]["chips"] == 4 and rec["2x4"]["chips"] == 8
    ratio = rec["2x4"]["flops"] / rec["1x4"]["flops"]
    assert ratio <= 0.6, ratio            # each rank computes its own rows only


@pytest.mark.parametrize("arch,changes,batch", TRAIN, ids=[t[0] for t in TRAIN])
def test_train_step_traces_on_1x4_and_2x4(arch, changes, batch):
    _assert_traced_and_split(_dry_run(arch, "train", batch, changes))


@pytest.mark.parametrize("heads", [4, 6])
def test_mla_decode_over_a_sequence_sharded_latent_traces(heads):
    """minicpm3's ``c_kv`` cache (L, B, S, r) shards its sequence over
    'model' (``cache_specs``); the decode step keeps it so."""
    _assert_traced_and_split(_dry_run("minicpm3-4b", "decode", 4, {"n_heads": heads}))


# ---------------------------------------------------- (b) real gloo meshes
def _launch(tmp_path, scenario: str, world: int, *args) -> dict:
    """``tests/test_torch_distributed.py``'s launcher for this module's
    scenarios: ``world`` processes on a ``FileStore``; rank 0's result."""
    store = str(tmp_path / f"store_{scenario}_{world}")
    out = tmp_path / f"{scenario}_{world}.json"
    code = (f"import test_torch_mesh_faults as t; "
            f"t._worker({scenario!r}, %d, {world}, {store!r}, {str(out)!r}, {list(args)!r})")
    procs = [subprocess.Popen([sys.executable, "-c", code % r], env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RUN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"rank {r} of {scenario}:\n{log[-3000:]}"
              for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    assert not failed, "\n".join(failed)
    return json.loads(out.read_text())


def _worker(scenario, rank, world, store, out, args):
    import torch
    import torch.distributed as dist

    torch.manual_seed(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=RENDEZVOUS))
    try:
        result = globals()[f"_scenario_{scenario}"](rank, *args)
        if rank == 0:
            Path(out).write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


def _cfg(arch, changes):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch).reduced(), **changes)


def _batch(cfg, b, s, seed=0) -> dict:
    """One microbatch of every input the family takes (whisper's frames
    too), shaped as ``batch_struct`` gives them."""
    import torch

    from repro_torch.train.train_loop import batch_struct

    rng = np.random.default_rng(seed)
    return {k: (rng.integers(0, cfg.vocab, shape).astype(np.int32) if dt == torch.int32
                else rng.standard_normal(shape).astype(np.float32))
            for k, (shape, dt) in batch_struct(cfg, b, s, 1).items()}


def _scenario_train(rank, arch, changes):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptConfig, opt_init
    from repro_torch.train.train_loop import make_train_step, mesh_layout, place

    cfg = _cfg(arch, changes)
    oc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    b, s = 4, 64
    batch = _batch(cfg, b, s)
    model = build_model(cfg)
    mesh = make_host_mesh(1, 4)
    layout = mesh_layout(cfg, mesh, oc)
    step, _ = make_train_step(cfg, oc, b, s, device="cpu", mesh=mesh)
    p = model.init(0, device="cpu")
    sharded = _whole(step(place(p, mesh, layout.params),
                          place(opt_init(oc, p), mesh, layout.opt_state), batch))
    if rank:
        return None
    step1, _ = make_train_step(cfg, oc, b, s, device="cpu")
    p = model.init(0, device="cpu")
    return _compare_after_step(step1(p, opt_init(oc, p), batch), sharded, oc)


def _scenario_mla_decode(rank, changes):
    import torch

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.train.train_loop import (make_prefill_step, make_serve_step, mesh_layout,
                                              place)

    cfg = _cfg("minicpm3-4b", changes)
    model = build_model(cfg)
    b, pre, cap, new = 4, 31, 64, 4
    toks = np.random.default_rng(0).integers(3, cfg.vocab, (b, pre + 1)).astype(np.int32)
    mesh = make_host_mesh(1, 4)
    params = place(model.init(0, device="cpu"), mesh, mesh_layout(cfg, mesh).params)
    prefill, _, _ = make_prefill_step(cfg, b, pre, device="cpu", mesh=mesh)
    serve, new_cache = make_serve_step(cfg, b, cap, device="cpu", mesh=mesh)
    cache = new_cache()
    c_pl = [str(x) for x in cache["layers"]["c_kv"].placements]
    _, cache = prefill(params, {"tokens": toks[:, :pre]}, cache)
    got, nxt = [], torch.from_numpy(toks[:, pre:])
    for _ in range(new):
        nxt, cache = serve(params, nxt, cache)
        got.append(nxt[:, 0].tolist())
    if rank:
        return None
    p = model.init(0, device="cpu")
    want, nxt = [], torch.from_numpy(toks[:, pre:])
    with torch.no_grad():
        c = model.init_cache(b, cap, device="cpu")
        _, c = model.forward_with_cache(p, {"tokens": toks[:, :pre]}, c)
        for _ in range(new):
            logits, c = model.decode_step(p, nxt, c)
            nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
            want.append(nxt[:, 0].tolist())
    return {"c_kv_placements": c_pl, "got": got, "want": want}


GLOO_TRAIN = [
    ("whisper-medium", {}),
    ("zamba2-1.2b", {}),
    ("minicpm3-4b", {"n_heads": 6}),
    ("qwen3-8b", {"n_heads": 4, "n_kv_heads": 2}),
    # remat="full" on a mesh: each layer's FSDP gather, its local calls and
    # their collectives run again in the backward's recompute
    ("qwen3-8b", {"n_heads": 4, "n_kv_heads": 2, "remat": "full"}),
    ("qwen2-moe-a2.7b", {"remat": "full"}),
]


@pytest.mark.parametrize("arch,changes", GLOO_TRAIN,
                         ids=[a + (f"-remat-{c['remat']}" if "remat" in c else "")
                              for a, c in GLOO_TRAIN])
def test_train_step_on_a_1x4_mesh_equals_one_device(tmp_path, arch, changes):
    r = _launch(tmp_path, "train", 4, arch, changes)
    for k, (one, sharded) in r["metrics"].items():
        assert sharded == pytest.approx(one, rel=TOL), k
    assert r["step"] == [1, 1]
    assert r["moments_rel"] <= TOL, r["moments_rel"]
    assert r["params_ok"]


def test_mla_decode_over_a_sequence_sharded_latent_equals_one_device(tmp_path):
    r = _launch(tmp_path, "mla_decode", 4, {"n_heads": 6})
    # the latent cache (L, B, S, r): its sequence on 'model'; 'data' has
    # size 1 and shards nothing
    assert r["c_kv_placements"] == ["R", "S(2)"], r["c_kv_placements"]
    assert r["got"] == r["want"]
