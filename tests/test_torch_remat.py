"""Activation rematerialisation (``remat``) in the port's model against
``"none"`` and against the reference's ``jax.checkpoint``, on the CPU.

(a) ``"full"`` and ``"selective"`` give the same bits as ``"none"`` in the
loss and in every gradient leaf, for all eleven reduced configs: the
recompute runs the same ops on the same inputs, and the CPU repeats itself
bit for bit (``.view(int32)`` patterns compared).
(b) Against the reference's ``jax.value_and_grad(loss)`` under the same
``remat``: the loss and every gradient leaf within
``tests/test_torch_train_loop.py``'s TOL of 1e-4 (max |port - jax| over
max |jax|, float32 sums in other orders).
(c) Memory, on fake tensors, through the dry run's own L-sweep (one and two
layers) on a fake (2, 2) group; the bounds are derived at the test.
(d) ``unroll_layers``: the decoder's layers run unwrapped, the encoder's
stay wrapped, as in the reference.
(e) A forward without autograd recording runs no checkpoint.

(a), (c), (d) and (e) import no JAX.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import build_model, flatten_with_paths, tree_leaves
from repro_torch.models import model as model_mod
from repro_torch.train.train_loop import value_and_grad

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TOL = 1e-4
MODES = ("none", "full", "selective")


def _batch(cfg, seed=1, b=2, s=64):
    """64 positions: two SSD chunks of 32, vlm patches and whisper frames."""
    rng = np.random.default_rng(seed)
    n_tok = s - cfg.vision_tokens if cfg.family == "vlm" else s
    out = {"tokens": rng.integers(0, cfg.vocab, (b, n_tok)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(0, 1, (b, s // cfg.frontend_downsample,
                                          cfg.frontend_dim or cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.normal(0, 1, (b, cfg.vision_tokens,
                                           cfg.frontend_dim)).astype(np.float32)
    return out


def _grads(cfg, params, batch):
    (loss, _), grads = value_and_grad(build_model(cfg).loss)(params, batch)
    return loss, dict(flatten_with_paths(grads))


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.fixture
def count_checkpoints(monkeypatch):
    """The number of ``torch.utils.checkpoint`` calls the model makes."""
    calls = []
    real = model_mod.checkpoint

    def counted(fn, *args, **kwargs):
        calls.append(fn)
        return real(fn, *args, **kwargs)

    monkeypatch.setattr(model_mod, "checkpoint", counted)
    return calls


# ------------------------------------------------- (a) the same bits as none
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_remat_gradients_bit_equal_none(arch, count_checkpoints):
    base = get_config(arch).reduced()
    params = build_model(base).init(0, device="cpu")
    batch = _batch(base)
    want_loss, want = _grads(dataclasses.replace(base, remat="none"), params, batch)
    assert not count_checkpoints
    layers = base.n_layers + (base.n_encoder_layers if base.family == "encdec" else 0)
    for mode in ("full", "selective"):
        loss, got = _grads(dataclasses.replace(base, remat=mode), params, batch)
        assert len(count_checkpoints) == layers, mode       # one a layer
        count_checkpoints.clear()
        assert torch.equal(_bits(loss), _bits(want_loss)), mode
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(_bits(got[k]), _bits(want[k])), (mode, k)
    assert not any(p.requires_grad for p in tree_leaves(params))


# ------------------------------------------------ (b) against jax.checkpoint
REFERENCE_CASES = ([(a, "full") for a in sorted(ARCHS)]
                   + [(a, "selective") for a in ("internlm2-1.8b", "qwen2-moe-a2.7b",
                                                  "mamba2-130m")])


@pytest.mark.parametrize("arch,mode", REFERENCE_CASES,
                         ids=[f"{a}-{m}" for a, m in REFERENCE_CASES])
def test_remat_gradients_match_jax(arch, mode):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.models.model import build_model as jbuild
    from repro_torch.models import params_from_jax

    jcfg = dataclasses.replace(jget_config(arch).reduced(), remat=mode)
    tcfg = dataclasses.replace(get_config(arch).reduced(), remat=mode)
    w = jax.device_get(jbuild(jcfg).init(jax.random.PRNGKey(0)))
    batch = _batch(tcfg)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jbuild(jcfg).loss, has_aux=True))(
        w, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, got = _grads(tcfg, params_from_jax(w, device="cpu"), batch)
    assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
    want = dict(flatten_with_paths(jax.device_get(jgrads)))
    assert set(got) == set(want)
    for k, wv in want.items():
        wv = np.asarray(wv, np.float32)
        g = got[k].detach().float().numpy()
        assert g.shape == wv.shape, k
        rel = float(np.max(np.abs(g - wv)) / max(float(np.max(np.abs(wv))), 1e-30))
        assert rel < TOL, (k, rel)


# ------------------------------------------------------------- (c) memory
_SWEEP = """
import dataclasses, json, math
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch.dryrun import fake_group, run_cell
from repro_torch.launch.mesh import MeshShape
from repro_torch.launch.report import cells_table
from repro_torch.models import build_model, flatten_with_paths
from repro_torch.train.train_loop import mesh_layout
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Shard

base = get_config("internlm2-1.8b").reduced()
shape = ShapeConfig("train_4k", 256, 8, "train")      # train_4k's name, the report's column
out = {}
with fake_group(4):
    for mode in ("none", "full", "selective"):
        cfg = dataclasses.replace(base, remat=mode)
        rec = run_cell("internlm2-1.8b", "train_4k", multi_pod=False, cfg=cfg, shape=shape,
                       mesh_shape=MeshShape(("data", "model"), (2, 2)), counting="calibrated")
        out[mode] = {"status": rec["status"], "remat": rec["remat"],
                     "per_layer_peak": rec["calibration"]["per_period"]["peak"],
                     "per_layer_flops": rec["calibration"]["per_period"]["flops"],
                     "row": [r for r in cells_table({("internlm2-1.8b", "train_4k", "pod1"): rec})
                             if r.startswith("| internlm2-1.8b ")][0]}
    # one layer's parameter bytes on this rank: each leaf's local block
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    pl = dict(flatten_with_paths(mesh_layout(base, mesh).params))
    shapes = dict(flatten_with_paths(build_model(base).init(0, device="meta")))
    local = 0
    for k, t in shapes.items():
        if k.startswith("layers/"):
            ways = math.prod(mesh.size(i) for i, p in enumerate(pl[k]) if isinstance(p, Shard))
            local += t.numel() // base.n_layers // ways * t.element_size()
out["layer_param_bytes_local"] = local
print("RESULT", json.dumps(out))
"""


def test_dry_run_per_layer_peak_holds_one_layer_input():
    """The dry run's L-sweep of reduced internlm2 (d = 128, 4 heads of 32,
    d_ff = 256, float32) at (8, 256) on a fake (2, 2) mesh: each rank holds
    B/2 = 4 rows. One layer input there is x = 4 * 256 * 128 * 4 bytes
    (512 KiB).

    Under ``"full"`` a further layer adds to the peak what the forward
    keeps of it, its input, and what the backward keeps of it, its
    parameters' gradient (the stacked leaves' gradients grow by one layer
    on this rank, p): x <= increment <= x + p.

    Under ``"none"`` autograd keeps, among much else, the layer's input and
    the attention's probabilities, (B/2) * (H/2) * S * S * 4 bytes = 4 * 2 *
    256 * 256 * 4 = 4x here: increment >= 5x. ``"selective"`` keeps the
    products with no batch dims besides what ``"full"`` keeps, and less
    than ``"none"``. Recomputing adds the layer's forward FLOPs: ``"full"``
    counts more per layer than ``"selective"``, which counts more than
    ``"none"``."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_SWEEP)], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.split("RESULT ", 1)[1])
    x = 4 * 256 * 128 * 4
    p = out["layer_param_bytes_local"]
    assert 0 < p < x
    inc = {m: out[m]["per_layer_peak"] for m in MODES}
    assert x <= inc["full"] <= x + p, (inc, x, p)
    assert inc["none"] >= 5 * x, (inc, x)
    assert inc["full"] < inc["selective"] < inc["none"], inc
    flops = {m: out[m]["per_layer_flops"] for m in MODES}
    assert flops["none"] < flops["selective"] < flops["full"], flops
    for m in MODES:
        assert out[m]["status"] == "ok" and out[m]["remat"] == m
        assert f"remat {m} |" in out[m]["row"], out[m]["row"]


# ------------------------------------------------------ (d) unroll_layers
@pytest.mark.parametrize("arch,unroll,wrapped", [
    ("whisper-medium", False, 4), ("whisper-medium", True, 2),   # 2 encoder + 2 decoder
    ("qwen3-8b", True, 0)])
def test_unroll_layers_leaves_the_decoder_unwrapped(arch, unroll, wrapped, count_checkpoints):
    base = get_config(arch).reduced()
    params = build_model(base).init(0, device="cpu")
    batch = _batch(base)
    want_loss, want = _grads(base, params, batch)
    cfg = dataclasses.replace(base, remat="full", unroll_layers=unroll)
    loss, got = _grads(cfg, params, batch)
    assert len(count_checkpoints) == wrapped
    assert torch.equal(_bits(loss), _bits(want_loss))
    assert all(torch.equal(_bits(got[k]), _bits(want[k])) for k in want)


# ------------------------------------------------ (e) nothing to record
def test_forward_without_recording_runs_no_checkpoint(count_checkpoints):
    """Under ``torch.no_grad()``, or with grad mode on and nothing that
    requires grad, a ``"full"`` forward (and the serving path) runs the
    same ops as ``"none"``: no checkpoint, the same logits."""
    base = get_config("zamba2-1.2b").reduced()
    cfg = dataclasses.replace(base, remat="full")
    params = build_model(base).init(0, device="cpu")
    tokens = _batch(base)["tokens"]
    with torch.no_grad():
        want, _, _ = build_model(base).forward(params, {"tokens": tokens})
        got, _, _ = build_model(cfg).forward(params, {"tokens": tokens})
        cache = build_model(cfg).init_cache(2, 80, device="cpu")
        build_model(cfg).forward_with_cache(params, {"tokens": tokens}, cache)
    assert torch.equal(_bits(got), _bits(want))
    again, _, _ = build_model(cfg).forward(params, {"tokens": tokens})   # grad mode on
    assert torch.equal(_bits(again), _bits(want))
    assert not count_checkpoints
    with pytest.raises(ValueError, match="remat"):
        _grads(dataclasses.replace(base, remat="some"), params, {"tokens": tokens})
