"""The port's backward pass and training step (``repro_torch.models``'s
``loss``, ``repro_torch.train.train_loop``) against the JAX package's, on
the CPU.

Both packages start from the same weights: the reference's ``model.init``
draws them and :func:`repro_torch.models.params_from_jax` carries them
across. Batches are numpy arrays drawn from a seed, or read from a small
Porto lake by both packages' ``TrajectoryBatcher``.

Tolerances. Gradients: max |port - jax| / max |jax| below 1e-4 in every
leaf, the forward tests' bound (``tests/test_torch_models.py``): the
backward takes the same float32 sums in another order as the forward
does, through the same number of layers, and measures about 3e-6. Losses
to 1e-5 relative. A training step is held through its moments:
they must lie within 1e-4 of their leaf's largest magnitude, and each
parameter within what the two packages' moments imply (see
``_close_after_step``).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.models import (build_model, flatten_with_paths, params_from_jax,  # noqa: E402
                                tree_leaves)
from repro_torch.train.optimizer import OptConfig, opt_init  # noqa: E402
from repro_torch.train.train_loop import (make_train_step, run_train_loop,  # noqa: E402
                                          value_and_grad)

TOL = 1e-4


def _flat(tree):
    """``{path: leaf}`` of a nested dict, in the port's one leaf order."""
    return dict(flatten_with_paths(tree))


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(float(np.max(np.abs(want))), 1e-30))


def _batch(cfg, seed, b, s):
    rng = np.random.default_rng(seed)
    n_tok = s - cfg.vision_tokens if cfg.family == "vlm" else s
    out = {"tokens": rng.integers(0, cfg.vocab, (b, n_tok)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(0, 1, (b, s // cfg.frontend_downsample,
                                          cfg.frontend_dim or cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.normal(0, 1, (b, cfg.vision_tokens, cfg.frontend_dim)).astype(np.float32)
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_gradients_match_jax(arch):
    """Every config's reduced variant: the loss and the gradient of every
    parameter leaf (the stacked per-layer tensors) against ``jax.grad``.
    64 positions: two SSD chunks of 32, vlm patches and whisper frames."""
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    w = jax.device_get(jbuild(jcfg).init(jax.random.PRNGKey(0)))
    batch = _batch(jcfg, 1, 2, 64)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jbuild(jcfg).loss, has_aux=True))(
        w, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(w, device="cpu")
    (loss, _), grads = value_and_grad(build_model(tcfg).loss)(params, batch)
    assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
    want, got = _flat(jax.device_get(jgrads)), _flat(grads)
    assert set(got) == set(want)
    assert not any(p.requires_grad for p in tree_leaves(params))
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert _rel(got[k], want[k]) < TOL, (k, _rel(got[k], want[k]))


def _adam_ratio(m, v, t, oc):
    """Adam's update ratio from stored moments, in float64."""
    m, v = np.asarray(m, np.float64), np.asarray(v, np.float64)
    return (m / (1 - oc.b1 ** t)) / (np.sqrt(v / (1 - oc.b2 ** t)) + oc.eps)


def _close_after_step(tp, jp, ts, js, oc):
    """Moments within TOL of their leaf's largest magnitude; then each
    parameter within what its moments imply: lr * |ratio(port's moments) -
    ratio(jax's moments)| + TOL * lr + two float32 ulps of the parameter.
    Near a zero gradient (|g| ~ eps) Adam's ratio g / (|g| + eps) turns
    a gradient error far below TOL into a large ratio difference, so the
    bound is per element, from the moments, not one number."""
    t = int(js["step"])
    assert int(ts["step"]) == t
    tm, tv, jm, jv = (_flat(x) for x in (ts["m"], ts["v"], jax.device_get(js["m"]),
                                          jax.device_get(js["v"])))
    for k in jm:
        assert _rel(tm[k], jm[k]) < TOL and _rel(tv[k], jv[k]) < TOL, k
    for k, v in _flat(jax.device_get(jp)).items():
        got = _flat(tp)[k].numpy()
        dr = np.abs(_adam_ratio(tm[k].numpy(), tv[k].numpy(), t, oc)
                    - _adam_ratio(jm[k], jv[k], t, oc))
        bound = oc.lr * (dr + TOL) + 2.0 ** -22 * np.abs(v)
        assert np.all(np.abs(got - v) <= bound), (k, float(np.max(np.abs(got - v) - bound)))


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum):
    """One ``make_train_step`` against the reference's at accum 1 and 2:
    parameters, both moments, the step counter and the metrics."""
    from repro.launch.mesh import make_host_mesh
    from repro.train import optimizer as jopt
    from repro.train.train_loop import make_train_step as jmake

    kw = dict(lr=1e-3, warmup_steps=0, total_steps=10, grad_clip=1.0)
    jcfg = dataclasses.replace(jget_config("internlm2-1.8b").reduced(), grad_accum=accum)
    tcfg = dataclasses.replace(get_config("internlm2-1.8b").reduced(), grad_accum=accum)
    w = jax.device_get(jbuild(jcfg).init(jax.random.PRNGKey(3)))
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (4, 32)).astype(np.int32)
    batch = {"tokens": toks.reshape(accum, 4 // accum, 32)}
    mesh = make_host_mesh(1, 1)
    jstep, *_ = jmake(jcfg, mesh, jopt.OptConfig(**kw), global_batch=4, seq=32)
    jp = jax.tree.map(jnp.asarray, w)
    js = jopt.opt_init(jopt.OptConfig(**kw), jp)
    jp, js, jm = jstep(jp, js, batch)
    tstep, bstruct = make_train_step(tcfg, OptConfig(**kw), 4, 32, device="cpu")
    assert bstruct["tokens"][0] == (accum, 4 // accum, 32)
    tp = params_from_jax(w, device="cpu")
    ts = opt_init(OptConfig(**kw), tp)
    tp, ts, tm = tstep(tp, ts, batch)
    for k in ("loss", "ce_loss", "grad_norm", "lr"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    _close_after_step(tp, jp, ts, js, OptConfig(**kw))
    assert not any(p.requires_grad for p in tree_leaves(tp))


def test_loss_decreases_and_resumes(tmp_path):
    """The port of ``tests/test_train_loop.py::test_loss_decreases_and_resumes``."""
    from repro_torch.data.pipeline import synthetic_token_iter
    from repro_torch.train.checkpoint import CheckpointManager

    cfg = get_config("internlm2-1.8b").reduced()
    oc = OptConfig(lr=1e-3, warmup_steps=5, total_steps=60)
    data = synthetic_token_iter(cfg.vocab, seq_len=64, global_batch=4)
    mgr = CheckpointManager(tmp_path, async_save=False, keep=2)
    state, hist = run_train_loop(
        cfg, oc, data, global_batch=4, seq=64, steps=25,
        checkpoint_mgr=mgr, checkpoint_every=10, log_every=5, device="cpu",
    )
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.3
    assert mgr.latest_step() == 25
    state2, hist2 = run_train_loop(
        cfg, oc, data, global_batch=4, seq=64, steps=30,
        checkpoint_mgr=mgr, checkpoint_every=0, log_every=5, device="cpu",
    )
    assert hist2[0]["step"] == 25


def test_spatial_lm_step_from_lake_matches_reference(tmp_path):
    """spatial-lm (reduced widths, the tokenizer's vocab as the CLI sets it)
    trained one step on a batch read from a small Porto lake: both
    packages' batchers give the same tokens, and both steps the same
    parameters and state."""
    from repro.data.pipeline import TrajectoryBatcher as JBatcher
    from repro.launch.mesh import make_host_mesh
    from repro.train import optimizer as jopt
    from repro.train.train_loop import make_train_step as jmake
    from repro_torch.core.writer import write_file
    from repro_torch.data.pipeline import TrajectoryBatcher
    from repro_torch.data.synthetic import PORTO_BBOX, porto_taxi_like
    from repro_torch.data.tokenizer import GeoTokenizer

    path = str(tmp_path / "porto.spqf")
    write_file(path, columns=porto_taxi_like(n_traj=300), sort="hilbert", device="cpu")
    tok = GeoTokenizer(PORTO_BBOX, order=6)
    kw = dict(tok=tok, seq_len=64, global_batch=4)
    got = next(iter(TrajectoryBatcher([path], kw["tok"], seq_len=64, global_batch=4,
                                      bbox=PORTO_BBOX, device="cpu")))
    want = next(iter(JBatcher([path], kw["tok"], seq_len=64, global_batch=4, bbox=PORTO_BBOX)))
    assert np.array_equal(got["tokens"], want["tokens"])

    jcfg = dataclasses.replace(jget_config("spatial-lm").reduced(), vocab=tok.vocab)
    tcfg = dataclasses.replace(get_config("spatial-lm").reduced(), vocab=tok.vocab)
    okw = dict(lr=3e-4, warmup_steps=1, total_steps=10)
    w = jax.device_get(jbuild(jcfg).init(jax.random.PRNGKey(0)))
    jstep, *_ = jmake(jcfg, make_host_mesh(1, 1), jopt.OptConfig(**okw), global_batch=4, seq=64)
    jp = jax.tree.map(jnp.asarray, w)
    jp, js, jm = jstep(jp, jopt.opt_init(jopt.OptConfig(**okw), jp), want)
    tstep, _ = make_train_step(tcfg, OptConfig(**okw), 4, 64, device="cpu")
    tp = params_from_jax(w, device="cpu")
    tp, ts, tm = tstep(tp, opt_init(OptConfig(**okw), tp), got)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    _close_after_step(tp, jp, ts, js, OptConfig(**okw))


def test_flash_raises_under_grad_on_cpu():
    """The flash op has no backward in either package: the reference's
    ``jax.grad`` through its Pallas kernel fails, and the port's op raises
    on the CPU as on the card, alone and inside ``loss``/a train step. With
    no gradient wanted it runs."""
    from repro.kernels.flash_attention import ops as jops
    from repro_torch.kernels.flash_attention import ops

    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(0, 1, (1, 2, 128, 32)).astype(np.float32) for _ in range(3))
    with pytest.raises(Exception):
        jax.grad(lambda q: jops.attention(q, k, v, use_pallas=True, interpret=True).sum())(q)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    with pytest.raises(RuntimeError, match="attn_impl='ref' or 'blocked'"):
        ops.attention(tq.requires_grad_(), tk, tv)
    with torch.no_grad():
        assert ops.attention(tq, tk, tv).shape == (1, 2, 128, 32)
    out = ops.attention(tq.detach(), tk, tv)
    assert out.grad_fn is None

    cfg = dataclasses.replace(get_config("qwen3-8b").reduced(), attn_impl="flash")
    params = build_model(cfg).init(0, device="cpu")
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 128)).astype(np.int32)}
    build_model(cfg).loss(params, batch)           # forward only: fine
    with pytest.raises(RuntimeError, match="no backward"):
        value_and_grad(build_model(cfg).loss)(params, batch)
    step, _ = make_train_step(cfg, OptConfig(), 2, 128, device="cpu")
    with pytest.raises(RuntimeError, match="no backward"):
        step(params, opt_init(OptConfig(), params), {"tokens": batch["tokens"][None]})


def test_tree_walks_hold_no_reference_cycles():
    """Flattening a tree leaves nothing that only the cycle collector frees:
    the train step flattens each microbatch's gradients, and on the card a
    cycle would keep each step's gradient tree alive until the next
    collection."""
    import gc
    import weakref

    from repro_torch.models import unflatten_like

    leaf = torch.ones(4)
    ref = weakref.ref(leaf)
    tree = {"b": {"y": leaf, "x": torch.zeros(2)}, "a": torch.zeros(1)}
    gc.disable()
    try:
        pairs = flatten_with_paths(tree)
        assert [k for k, _ in pairs] == ["a", "b/x", "b/y"]
        assert flatten_with_paths(tree, upto={"a": 0, "b": 0})[1] == ("b", tree["b"])
        rebuilt = unflatten_like(tree, tree_leaves(tree))
        assert rebuilt["b"]["y"] is leaf
        del leaf, tree, pairs, rebuilt
        assert ref() is None
    finally:
        gc.enable()


def test_attention_plain_is_differentiable():
    """``attention_plain`` (GQA, causal, Sq < Sk) gives the gradients of the
    reference's plain attention."""
    from repro.kernels.flash_attention import ops as jops
    from repro_torch.kernels.flash_attention import ops

    rng = np.random.default_rng(1)
    q = rng.normal(0, 1, (2, 4, 96, 32)).astype(np.float32)
    k, v = (rng.normal(0, 1, (2, 2, 128, 32)).astype(np.float32) for _ in range(2))
    w = rng.normal(0, 1, (2, 4, 96, 32)).astype(np.float32)
    jg = jax.grad(lambda q, k, v: (jops.attention(q, k, v) * w).sum(), argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (ops.attention_plain(tq, tk, tv) * torch.from_numpy(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        assert _rel(got, want) < TOL


def test_forward_prefill_and_serve_steps():
    """``make_forward_step`` gives the reference's argmax tokens; the prefill
    step's next token is the forward's argmax at the last prompt position,
    and one serve step after it the forward's argmax one position on."""
    from repro.launch.mesh import make_host_mesh
    from repro.train.train_loop import make_forward_step as jforward
    from repro_torch.train.train_loop import (make_forward_step, make_prefill_step,
                                              make_serve_step)

    jcfg, tcfg = jget_config("internlm2-1.8b").reduced(), get_config("internlm2-1.8b").reduced()
    w = jax.device_get(jbuild(jcfg).init(jax.random.PRNGKey(2)))
    params = params_from_jax(w, device="cpu")
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (2, 33)).astype(np.int32)
    fwd, bstruct = make_forward_step(tcfg, 2, 32, device="cpu")
    assert bstruct["tokens"][0] == (2, 32)
    want = np.asarray(jforward(jcfg, make_host_mesh(1, 1), 2, 32)[0](
        jax.tree.map(jnp.asarray, w), {"tokens": toks[:, :32]}))
    full = fwd(params, {"tokens": toks})
    assert np.array_equal(fwd(params, {"tokens": toks[:, :32]}).numpy(), want)
    prefill, _, new_cache = make_prefill_step(tcfg, 2, 40, device="cpu")
    nxt, cache = prefill(params, {"tokens": toks[:, :32]}, new_cache())
    assert nxt.dtype == torch.int32 and torch.equal(nxt[:, 0], full[:, 31])
    serve, _ = make_serve_step(tcfg, 2, 40, device="cpu")
    nxt2, cache = serve(params, toks[:, 32:33], cache)
    assert torch.equal(nxt2[:, 0], full[:, 32]) and int(cache["pos"]) == 33
