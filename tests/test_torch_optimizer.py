"""The port's optimizers (``repro_torch.train.optimizer``) against the JAX
package's on the same trees, on the CPU.

Trees are nested dicts of numpy leaves drawn from a seed: matrices, a
stacked (layers, d_in, d_out) leaf and vectors, so weight decay meets both
ranks and the flatten order meets nested keys. Each update runs three
steps in both packages from the same state.

Tolerance. Both compute the same float32 elementwise formulas; they differ
only where a reduction (the global norm, Adafactor's means) adds in another
order, by a few ulps, and where the two libraries' float32 ``cos``, ``pow``
and ``sqrt`` round differently, by an ulp. A step moves a parameter by at
most lr * (|update| + wd |p|) with |update| <= 1 for AdamW (Adam's ratio)
and for Adafactor (its RMS clip), so an ulp-level relative error in the
update is far below ``1e-6 * lr`` per step in absolute terms;
parameters are held to max |port - jax| <= 1e-6 (lr = 1e-2, three steps)
and float32 moments to 1e-6 of their leaf's largest magnitude (a moment
sums terms of both signs, so an element's own relative error can exceed an
ulp where the terms cancel). bf16 moments round to bf16 after each
step; an ulp-level float32 difference can flip that rounding in a tie
region, which moves a moment by one bf16 ulp (2^-8 relative) and the next
update by at most about 2^-8: the parameters are then held to
3 * lr * 2^-8 = 1.2e-4 and the moments to 2^-8 of their largest magnitude.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.models import flatten_with_paths  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402


def _tree(rng):
    return {
        "w": rng.normal(0, 1, (6, 5)).astype(np.float32),
        "layers": {"stack": rng.normal(0, 0.1, (2, 4, 3)).astype(np.float32),
                   "scale": (1 + rng.normal(0, 0.1, (2, 3))).astype(np.float32)},
        "b": rng.normal(0, 1, (5,)).astype(np.float32),
    }


def _grads(rng, tree, scale=1.0):
    return {k: _grads(rng, v, scale) if isinstance(v, dict)
            else (rng.normal(0, scale, v.shape)).astype(np.float32) for k, v in tree.items()}


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


def _flat(tree):
    """``{path: leaf}`` of a nested dict, in the port's one leaf order."""
    return dict(flatten_with_paths(tree))


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def test_lr_schedule_matches_reference():
    oc = topt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    joc = jopt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    for s in range(0, 121, 3):
        got = float(topt.lr_schedule(oc, torch.tensor(s, dtype=torch.int32)))
        want = float(jopt.lr_schedule(joc, jnp.asarray(s, jnp.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7), s


@pytest.mark.parametrize("scale", [0.01, 100.0])
def test_global_norm_and_clip_match_reference(rng, scale):
    g = _grads(rng, _tree(rng), scale)
    got, gn = topt.clip_by_global_norm(_t(g), 1.0)
    want, wn = jopt.clip_by_global_norm(g, 1.0)
    assert float(gn) == pytest.approx(float(wn), rel=1e-6)
    assert float(topt.global_norm(_t(g))) == pytest.approx(float(jopt.global_norm(g)), rel=1e-6)
    fg, fw = _flat(got), _flat(want)
    for k in fw:
        np.testing.assert_allclose(_np(fg[k]), _np(fw[k]), rtol=1e-6, atol=1e-9, err_msg=k)


def test_opt_state_tree_matches_reference(rng):
    params = _tree(rng)
    for kind in ("adamw", "adafactor"):
        for sdt in ("float32", "bfloat16"):
            mine = _flat(topt.opt_init(topt.OptConfig(kind=kind), _t(params), sdt))
            theirs = _flat(jopt.opt_init(jopt.OptConfig(kind=kind), params, sdt))
            assert set(mine) == set(theirs), (kind, sdt)
            for k, v in theirs.items():
                assert tuple(mine[k].shape) == v.shape, (kind, sdt, k)
                assert str(mine[k].dtype).split(".")[1] == str(v.dtype), (kind, sdt, k)


@pytest.mark.parametrize("kind,state_dtype", [("adamw", "float32"), ("adamw", "bfloat16"),
                                              ("adafactor", "float32"),
                                              ("adafactor", "bfloat16")])
def test_update_matches_reference(rng, kind, state_dtype):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=1.0, weight_decay=0.1,
              kind=kind)
    oc, joc = topt.OptConfig(**kw), jopt.OptConfig(**kw)
    params = _tree(rng)
    tp = _t(params)
    ts = topt.opt_init(oc, tp, state_dtype)
    jp, js = params, jopt.opt_init(joc, params, state_dtype)
    bf16 = state_dtype == "bfloat16"
    for step in range(3):
        g = _grads(rng, params, scale=0.5 if step else 3.0)   # the first step clips
        tp, ts, tm = topt.opt_update(oc, tp, _t(g), ts)
        jp, js, jm = jopt.opt_update(joc, jp, g, js)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        assert ts["step"].dtype == torch.int32
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
    ptol = 3 * 1e-2 * 2 ** -8 if bf16 else 1e-6
    for k, v in _flat(jp).items():
        np.testing.assert_allclose(_np(_flat(tp)[k]), _np(v), rtol=0, atol=ptol, err_msg=k)
    for k, v in _flat({kk: vv for kk, vv in js.items() if kk != "step"}).items():
        got = _flat({kk: vv for kk, vv in ts.items() if kk != "step"})[k]
        assert str(got.dtype).split(".")[1] == str(v.dtype), k
        want = _np(v)
        tol = (2 ** -8 if bf16 else 1e-6) * float(np.abs(want).max())
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=tol, err_msg=k)


def test_update_is_in_place(rng):
    """The port's divergence: the given trees are the updated trees."""
    oc = topt.OptConfig(lr=1e-2, warmup_steps=0, total_steps=10)
    tp = _t(_tree(rng))
    w = tp["w"]
    state = topt.opt_init(oc, tp)
    before = w.clone()
    new_p, new_s, _ = topt.opt_update(oc, tp, _t(_grads(rng, _tree(rng))), state)
    assert new_p["w"] is w and new_s is state
    assert not torch.equal(w, before)
