"""The port on a ``torch.distributed`` mesh, on the CPU: 4 (or 2) gloo
processes that meet on a ``FileStore`` in the test's own directory (no
ports, so parallel test workers cannot collide), each with its own
rendezvous and run timeouts, so a hung group fails instead of hanging.

Every scenario compares the sharded run with the same run on one device in
rank 0's own process (the same seed, weights and batch):

* a (2, 2) train step for reduced internlm2 (dense), qwen2-moe (EP) and
  spatial-lm (SSM): loss and ``grad_norm`` within 1e-5 relative; both Adam
  moments within 1e-5 of their leaf's largest magnitude; each parameter
  within what the moments imply (Adam's first step divides g by |g| + eps,
  so near a zero gradient a sum-order difference far below 1e-5 moves the
  ratio a lot: see ``tests/test_torch_train_loop.py::_close_after_step``).
  The sharded step sums in other orders (partial sums over the FSDP and
  model axes); the measured worst moment difference is about 2e-6;
* elastic restore: a save on a (2, 1) mesh (2 processes) is restored on
  (2, 2) (4 processes); the checkpoint's bytes equal a one-device save of
  the same values, and one step after the restore is held as above;
* SP decode on (1, 4) with reduced qwen3 at 4 query and 2 kv heads: the K
  cache's spec puts the sequence on 'model', and the greedy tokens equal
  one device's exactly (``tests/test_distributed.py``'s SP test);
* the flash op on (1, 4) with those heads (q heads divide the axis, kv
  heads do not), through its plain version on the CPU: logits within 1e-5
  of their largest magnitude of one device's (float32 sums in other
  orders);
* the training CLI under ``torchrun`` on (2, 2): its logged losses equal a
  plain run's to the four decimals it prints.
"""

import datetime
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

TESTS = str(Path(__file__).resolve().parent)
SRC = str(Path(__file__).resolve().parents[1] / "src")
TOL = 1e-5
RUN_TIMEOUT = 420          # seconds a scenario's processes may take in all
RENDEZVOUS = 120           # seconds a process waits for the group


def _env():
    return dict(os.environ, PYTHONPATH=SRC + os.pathsep + TESTS + os.pathsep
                + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="2")


def _launch(tmp_path, scenario: str, world: int, *args) -> dict:
    """Run ``scenario`` in ``world`` processes; rank 0's JSON result."""
    store = str(tmp_path / f"store_{scenario}_{world}")
    out = tmp_path / f"{scenario}_{world}.json"
    code = (f"import test_torch_distributed as t; "
            f"t._worker({scenario!r}, {{rank}}, {world}, {store!r}, {str(out)!r}, {list(args)!r})")
    procs = [subprocess.Popen([sys.executable, "-c", code.format(rank=r)], env=_env(),
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


# ------------------------------------------------------------------ workers
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


def _cfg(arch):
    from repro_torch.configs import get_config

    return get_config(arch).reduced()


def _compare_after_step(one, sharded, oc) -> dict:
    """(params, opt_state, metrics) of the one-device and the sharded step:
    the largest relative differences, and whether every parameter lies
    within what its moments imply."""
    from repro_torch.models import flatten_with_paths

    p1, o1, m1 = one
    p2, o2, m2 = sharded
    rel = lambda a, b: float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))  # noqa: E731
    f1 = dict(flatten_with_paths({"p": p1, "o": o1}))
    f2 = dict(flatten_with_paths({"p": p2, "o": o2}))
    moments = max(rel(f2[k].float(), f1[k].float()) for k in f1 if k.startswith(("o/m/", "o/v/")))
    t = int(f1["o/step"])
    params_ok = True
    for k in f1:
        if not k.startswith("p/"):
            continue
        r = []
        for o in (f1, f2):
            m, v = (o["o/" + w + k[1:]].double() for w in ("m", "v"))
            r.append((m / (1 - oc.b1 ** t)) / ((v / (1 - oc.b2 ** t)).sqrt() + oc.eps))
        bound = oc.lr * ((r[0] - r[1]).abs() + TOL) + 2.0 ** -22 * f1[k].double().abs()
        params_ok &= bool(((f2[k].double() - f1[k].double()).abs() <= bound).all())
    return {"metrics": {k: [float(m1[k]), float(m2[k])] for k in m1},
            "moments_rel": moments, "params_ok": params_ok, "step": [t, int(f2["o/step"])]}


def _whole(result):
    """A sharded step's (params, opt_state, metrics) gathered whole: a
    collective, so every rank calls it."""
    from repro_torch.models import tree_map
    from repro_torch.sharding.dtensor import full

    return tuple(tree_map(full, t) for t in result)


def _step_batch(cfg, b, s, seed=0):
    return {"tokens": np.random.default_rng(seed).integers(0, cfg.vocab, (1, b, s))
            .astype(np.int32)}


def _scenario_train(rank, arch):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptConfig, opt_init
    from repro_torch.train.train_loop import make_train_step, mesh_layout, place

    cfg = _cfg(arch)
    oc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    b, s = 8, 64
    batch = _step_batch(cfg, b, s)
    model = build_model(cfg)
    mesh = make_host_mesh(2, 2)
    layout = mesh_layout(cfg, mesh, oc)
    step, _ = make_train_step(cfg, oc, b, s, device="cpu", mesh=mesh)
    p = model.init(0, device="cpu")
    sharded = _whole(step(place(p, mesh, layout.params),
                          place(opt_init(oc, p), mesh, layout.opt_state), batch))
    if rank:
        return None
    step1, _ = make_train_step(cfg, oc, b, s, device="cpu")
    p = model.init(0, device="cpu")
    one = step1(p, opt_init(oc, p), batch)
    return {**_compare_after_step(one, sharded, oc), "fallbacks": layout.fallbacks}


def _scenario_train_without_rules(rank, arch):
    """:func:`_scenario_train` with ``silu``, ``logaddexp`` and ``rsqrt``
    (which the SSM block and its norms run on DTensors) taken as ops this
    torch's DTensor has no rule for: they go through ``NoRuleFallback``
    (whole inputs, replicated outputs)."""
    import torch

    from repro_torch.sharding import dtensor

    forced = {torch.ops.aten.silu.default, torch.ops.aten.logaddexp.default,
              torch.ops.aten.rsqrt.default}
    has_rule = dtensor.has_sharding_rule
    seen = set()

    def without(func):
        if func in forced:
            seen.add(str(func))
            return False
        return has_rule(func)

    dtensor.has_sharding_rule = without
    result = _scenario_train(rank, arch)
    return result and {**result, "forced": sorted(seen)}


def _scenario_save(rank, ckdir, onedir):
    """A (2, 1) mesh saves the initial state; rank 0 also saves the same
    values from one device."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import OptConfig, opt_init
    from repro_torch.train.train_loop import mesh_layout, place

    cfg, oc = _cfg("internlm2-1.8b"), OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    mesh = make_host_mesh(2, 1)
    layout = mesh_layout(cfg, mesh, oc)
    p = build_model(cfg).init(7, device="cpu")
    o = opt_init(oc, p)
    CheckpointManager(ckdir, async_save=False).save(11, place(p, mesh, layout.params),
                                                    place(o, mesh, layout.opt_state))
    if rank:
        return None
    CheckpointManager(onedir, async_save=False).save(11, p, o)
    return {"mesh": list(mesh.shape)}


def _scenario_restore(rank, ckdir):
    """Restore the (2, 1) save on (2, 2) and step; rank 0 also restores on
    one device and steps."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_loop import make_train_step, mesh_layout

    cfg, oc = _cfg("internlm2-1.8b"), OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    b, s = 8, 32
    batch = _step_batch(cfg, b, s, seed=3)
    mesh = make_host_mesh(2, 2)
    layout = mesh_layout(cfg, mesh, oc)
    mgr = CheckpointManager(ckdir, async_save=False)
    step_n, p, o = mgr.restore_latest(device="cpu", mesh=mesh,
                                      placements={"params": layout.params,
                                                  "opt_state": layout.opt_state})
    placements_ok = all(tuple(t.placements) == pl for t, pl in
                        zip(_leaves(p), _leaves(layout.params)))
    sharded = _whole(make_train_step(cfg, oc, b, s, device="cpu", mesh=mesh)[0](p, o, batch))
    if rank:
        return None
    step1, p1, o1 = mgr.restore_latest(device="cpu")
    one = make_train_step(cfg, oc, b, s, device="cpu")[0](p1, o1, batch)
    return {**_compare_after_step(one, sharded, oc), "restored_step": [step_n, step1],
            "placements_ok": placements_ok, "mesh": list(mesh.shape)}


def _leaves(tree):
    from repro_torch.models import flatten_with_paths

    return [v for _, v in flatten_with_paths(tree)]


def _sp_cfg(impl):
    import dataclasses

    return dataclasses.replace(_cfg("qwen3-8b"), n_heads=4, n_kv_heads=2, attn_impl=impl)


def _scenario_sp_decode(rank):
    import torch

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.train.train_loop import (make_prefill_step, make_serve_step, mesh_layout,
                                              place)

    cfg = _sp_cfg("ref")
    model = build_model(cfg)
    b, pre, cap = 4, 31, 64
    toks = np.random.default_rng(0).integers(3, cfg.vocab, (b, pre + 1)).astype(np.int32)
    mesh = make_host_mesh(1, 4)
    params = place(model.init(0, device="cpu"), mesh, mesh_layout(cfg, mesh).params)
    prefill, _, _ = make_prefill_step(cfg, b, pre, device="cpu", mesh=mesh)
    serve, new_cache = make_serve_step(cfg, b, cap, device="cpu", mesh=mesh)
    cache = new_cache()
    k_pl = list(cache["layers"]["k"].placements)
    _, cache = prefill(params, {"tokens": toks[:, :pre]}, cache)
    nxt, cache = serve(params, toks[:, pre:], cache)
    if rank:
        return None
    p = model.init(0, device="cpu")
    with torch.no_grad():
        c = model.init_cache(b, cap, device="cpu")
        _, c = model.forward_with_cache(p, {"tokens": toks[:, :pre]}, c)
        logits, _ = model.decode_step(p, torch.from_numpy(toks[:, pre:]), c)
    return {"k_placements": [str(x) for x in k_pl],
            "got": nxt[:, 0].tolist(), "want": torch.argmax(logits[:, -1], -1).tolist()}


def _scenario_flash(rank):
    import torch

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding.dtensor import full, mesh_scope
    from repro_torch.train.train_loop import mesh_layout, place

    cfg = _sp_cfg("flash")
    model = build_model(cfg)
    toks = np.random.default_rng(1).integers(3, cfg.vocab, (2, 128)).astype(np.int32)
    mesh = make_host_mesh(1, 4)
    params = place(model.init(0, device="cpu"), mesh, mesh_layout(cfg, mesh).params)
    with torch.no_grad(), mesh_scope():
        got = full(model.forward(params, {"tokens": torch.from_numpy(toks)})[0])
    if rank:
        return None
    with torch.no_grad():
        want = model.forward(model.init(0, device="cpu"), {"tokens": toks})[0]
    return {"rel": float((got - want).abs().max() / want.abs().max())}


# -------------------------------------------------------------------- tests
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen2-moe-a2.7b", "spatial-lm"])
def test_sharded_train_step_equals_one_device(tmp_path, arch):
    r = _launch(tmp_path, "train", 4, arch)
    for k, (one, sharded) in r["metrics"].items():
        assert sharded == pytest.approx(one, rel=TOL), k
    assert r["step"] == [1, 1]
    assert r["moments_rel"] <= TOL, r["moments_rel"]
    assert r["params_ok"]


def test_ops_without_a_sharding_rule_fall_back(tmp_path):
    """Ops this torch's DTensor has no rule for (the card's torch 2.11 has
    none for ``flip`` and ``ne.Tensor``) are computed on whole inputs: the
    step still equals one device's."""
    r = _launch(tmp_path, "train_without_rules", 4, "spatial-lm")
    assert r["forced"] == ["aten.logaddexp.default", "aten.rsqrt.default",
                           "aten.silu.default"], r["forced"]
    for k, (one, sharded) in r["metrics"].items():
        assert sharded == pytest.approx(one, rel=TOL), k
    assert r["moments_rel"] <= TOL and r["params_ok"]


def test_elastic_restore_2x1_to_2x2(tmp_path):
    ck, one = str(tmp_path / "ck"), str(tmp_path / "one")
    saved = _launch(tmp_path, "save", 2, ck, one)
    assert saved["mesh"] == [2, 1]
    for name in ("manifest.json", "data.bin"):
        assert (Path(ck) / "step_00000011" / name).read_bytes() == \
            (Path(one) / "step_00000011" / name).read_bytes(), name
    r = _launch(tmp_path, "restore", 4, ck)
    assert r["mesh"] == [2, 2] and r["restored_step"] == [11, 11] and r["placements_ok"]
    for k, (a, b) in r["metrics"].items():
        assert b == pytest.approx(a, rel=TOL), k
    assert r["moments_rel"] <= TOL and r["params_ok"]


def test_sp_decode_1x4_equals_one_device(tmp_path):
    r = _launch(tmp_path, "sp_decode", 4)
    # the K cache (L, B, S, H, D): the sequence on 'model' (its 2 kv heads
    # do not divide 4): SP decode; 'data' has size 1 and shards nothing
    assert r["k_placements"] == ["R", "S(2)"], r["k_placements"]
    assert r["got"] == r["want"]


def test_flash_on_mesh_reads_its_own_kv_heads(tmp_path):
    r = _launch(tmp_path, "flash", 4)
    assert r["rel"] <= TOL, r["rel"]


def test_cli_under_torchrun_equals_plain_run(tmp_path):
    common = ["--reduced", "--device", "cpu", "--steps", "4", "--global-batch", "8",
              "--seq", "32", "--ckpt-every", "2"]

    def losses(cmd, ck):
        r = subprocess.run(cmd + common + ["--ckpt-dir", str(tmp_path / ck)], capture_output=True,
                           text=True, env=_env(), timeout=RUN_TIMEOUT)
        assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr[-4000:]}"
        return r.stdout, [ln.split()[3] for ln in r.stdout.splitlines()
                          if ln.startswith("[train] step")]

    _, plain = losses([sys.executable, "-m", "repro_torch.launch.train"], "plain")
    out, sharded = losses([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
                           "--mesh-data", "2", "--mesh-model", "2"], "mesh")
    assert "[train] mesh {'data': 2, 'model': 2} over 4 rank(s), backend gloo" in out
    assert len(plain) == 2 and sharded == plain
    assert sorted(os.listdir(tmp_path / "mesh")) == ["latest", "step_00000002", "step_00000004"]
