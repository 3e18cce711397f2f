"""The port's partition rules (``repro_torch.sharding.specs``) against the
reference's (``repro.sharding.specs``), leaf by leaf.

For all eleven configs and the meshes (16, 16), (2, 16, 16) with
``fsdp_pod`` both ways, (2, 2), (4, 1) and (1, 4): every parameter leaf's
spec and every serving-cache leaf's spec (at a batch that shards and at
batch 1, where SP decode applies) must equal the reference's, and so must
the fallback notes, word for word and in order. The reference runs in a
subprocess with forced host devices (as ``tests/test_distributed.py``
does); its specs come back as JSON. The port reads only the mesh's axis
names and sizes (:class:`repro_torch.launch.mesh.MeshShape`), and its
parameter and cache shapes come from the no-allocation ``meta`` route,
held equal to the reference's ``eval_shape``. Exact equality throughout:
the rules are integer arithmetic on shapes.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.mesh import MeshShape, production_shape
from repro_torch.models import build_model, flatten_with_paths
from repro_torch.sharding.specs import P, cache_specs, param_specs, placements

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "2x2": (("data", "model"), (2, 2)),
          "4x1": (("data", "model"), (4, 1)),
          "1x4": (("data", "model"), (1, 4))}
CACHES = ((128, 1024), (1, 2048))      # (batch, max_len): batch-sharded, and SP decode

_REFERENCE = """
import dataclasses, json, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import ARCHS, get_config
from repro.models.model import build_model
from repro.sharding.specs import cache_specs, param_specs

MESHES = {meshes!r}
CACHES = {caches!r}

def norm(spec):
    return [list(a) if isinstance(a, tuple) else a for a in spec]

def flat(tree, specs):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    specs = jax.tree.leaves(specs, is_leaf=lambda x: type(x).__name__ == "PartitionSpec")
    return {{"/".join(str(getattr(k, "key", k)) for k in path): [list(leaf.shape), norm(s)]
            for (path, leaf), s in zip(leaves, specs)}}

devs = np.array(jax.devices())
out = {{}}
for arch in ARCHS:
    base = get_config(arch)
    model = build_model(base)
    pshape = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    cshapes = [jax.eval_shape(lambda b=b, n=n: model.init_cache(b, n)) for b, n in CACHES]
    for mname, (axes, shape) in MESHES.items():
        mesh = Mesh(devs[:int(np.prod(shape))].reshape(shape), axes)
        for pod in ((False, True) if "pod" in axes else (base.fsdp_pod,)):
            cfg = dataclasses.replace(base, fsdp_pod=pod)
            ps, pfb = param_specs(cfg, mesh, pshape)
            rec = {{"params": flat(pshape, ps), "params_fb": pfb, "caches": []}}
            for cs in cshapes:
                cspec, cfb = cache_specs(cfg, mesh, cs)
                rec["caches"].append({{"specs": flat(cs, cspec), "fb": cfb}})
            out[f"{{arch}}|{{mname}}|{{pod}}"] = rec
json.dump(out, sys.stdout)
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=512",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    code = textwrap.dedent(_REFERENCE.format(meshes=MESHES, caches=CACHES))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout)


def _flat(tree, specs) -> dict:
    spec_of = dict(flatten_with_paths(specs))
    return {k: [list(leaf.shape), [list(a) if isinstance(a, tuple) else a for a in spec_of[k]]]
            for k, leaf in flatten_with_paths(tree)}


@pytest.mark.parametrize("mname", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_equal_reference(reference, arch, mname):
    axes, shape = MESHES[mname]
    mesh = MeshShape(axes, shape)
    base = get_config(arch)
    model = build_model(base)
    pshape = model.init(0, device="meta")
    assert all(t.is_meta for _, t in flatten_with_paths(pshape))
    cshapes = [model.init_cache(b, n, device="meta") for b, n in CACHES]
    for pod in ((False, True) if "pod" in axes else (base.fsdp_pod,)):
        want = reference[f"{arch}|{mname}|{pod}"]
        cfg = dataclasses.replace(base, fsdp_pod=pod)
        specs, fb = param_specs(cfg, mesh, pshape)
        assert _flat(pshape, specs) == want["params"]    # shapes and specs, every leaf
        assert fb == want["params_fb"]
        for cs, cw in zip(cshapes, want["caches"]):
            cspec, cfb = cache_specs(cfg, mesh, cs)
            assert _flat(cs, cspec) == cw["specs"]
            assert cfb == cw["fb"]


def test_spec_prints_as_partition_spec_and_places():
    assert repr(P(None, ("pod", "data"), "model")) == \
        "PartitionSpec(None, ('pod', 'data'), 'model')"
    from torch.distributed.tensor import Replicate, Shard

    mesh = production_shape(multi_pod=True)
    assert placements(mesh, P(None, ("pod", "data"), "model")) == (Shard(1), Shard(1), Shard(2))
    assert placements(mesh, P()) == (Replicate(),) * 3
    # an axis of size 1 shards nothing
    assert placements(MeshShape(("data", "model"), (1, 4)), P(None, "data", "model")) == \
        (Replicate(), Shard(2))
    with pytest.raises(ValueError):
        placements(mesh, P("model", "model"))
