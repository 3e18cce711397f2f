"""The port's dense LM held against the JAX package's, on the CPU.

Both packages compute with the same weights: the reference's ``model.init``
draws them and :func:`repro_torch.models.params_from_jax` carries them
across. Tokens are made with numpy from a seed. JAX's ``flash`` runs its
Pallas kernel in interpret mode, as its own tests do; the port's ``flash``
runs its plain version on CPU tensors.

Configs: the reduced qwen3-8b with ``n_kv_heads=2`` (GQA with 2 query heads
per kv head, and qk-norm; ``reduced()`` alone gives Hq = Hkv = 4) and the
reduced internlm2-1.8b. Tolerance: max |port - jax| / max |jax| below 1e-4
in float32. The two packages take the same float32 sums in another order
(matmul blocking, softmax and norm reductions), which moves logits of
magnitude ~1 in the 6th-7th digit; 1e-4 leaves room for that and nothing
else.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402

TOL = 1e-4
ARCHS = {"qwen3-8b": {"n_kv_heads": 2}, "internlm2-1.8b": {}}


def _cfgs(arch, **kw):
    over = dict(ARCHS[arch], **kw)
    return (dataclasses.replace(jget_config(arch).reduced(), **over),
            dataclasses.replace(get_config(arch).reduced(), **over))


@pytest.fixture(scope="module")
def weights():
    """Reference weights per arch (numpy leaves), drawn once per module."""
    out = {}
    for arch in ARCHS:
        jcfg, _ = _cfgs(arch)
        out[arch] = jax.device_get(jbuild(jcfg).init(jax.random.PRNGKey(0)))
    return out


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-6))


def _toks(cfg, seed, shape):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _flat(tree, pre=""):
    if not isinstance(tree, dict):
        return {pre: tree}
    return {k: v for n, sub in tree.items() for k, v in _flat(sub, f"{pre}/{n}").items()}


def test_params_carry_across(weights):
    jcfg, tcfg = _cfgs("qwen3-8b")
    p = params_from_jax(weights["qwen3-8b"], device="cpu")
    assert p["layers"]["attn"]["wk"].shape == (tcfg.n_layers, tcfg.d_model,
                                               tcfg.n_kv_heads * tcfg.resolved_head_dim)
    assert "q_norm" in p["layers"]["attn"]
    assert np.array_equal(p["embed"].numpy(), np.asarray(weights["qwen3-8b"]["embed"]))
    # port init: same tree, shapes and dtypes as the reference's
    mine = build_model(tcfg).init(0, device="cpu")
    theirs = _flat(weights["qwen3-8b"])
    assert set(_flat(mine)) == set(theirs)
    for k, v in _flat(mine).items():
        assert tuple(v.shape) == theirs[k].shape and v.dtype == torch.float32, k


def test_bf16_leaves_carry_across_bit_for_bit(rng):
    a = jnp.asarray(rng.normal(0, 3, (5, 7)).astype(np.float32)).astype(jnp.bfloat16)
    got = params_from_jax({"w": {"x": jax.device_get(a)}}, device="cpu")["w"]["x"]
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(), np.asarray(a).view(np.int16))


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("impl", ["ref", "blocked", "flash"])
def test_forward_matches_jax(weights, arch, impl):
    jcfg, tcfg = _cfgs(arch, attn_impl=impl)
    toks = _toks(tcfg, 1, (2, 128))
    want, jaux, _ = jbuild(jcfg).forward(weights[arch], {"tokens": jnp.asarray(toks)})
    got, aux, mask = build_model(tcfg).forward(params_from_jax(weights[arch], device="cpu"),
                                               {"tokens": toks})
    assert aux == {} and mask is None and got.dtype == torch.float32
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_full_capacity_prefill_matches_jax(weights, arch):
    """Prefill of exactly the cache's capacity: the flash branch."""
    jcfg, tcfg = _cfgs(arch, attn_impl="flash")
    toks = _toks(tcfg, 2, (2, 128))
    jm, tm = jbuild(jcfg), build_model(tcfg)
    want, jc = jm.forward_with_cache(weights[arch], {"tokens": jnp.asarray(toks)},
                                     jm.init_cache(2, 128))
    got, tc = tm.forward_with_cache(params_from_jax(weights[arch], device="cpu"),
                                    {"tokens": toks}, tm.init_cache(2, 128, device="cpu"))
    assert _rel(got, want) < TOL
    assert int(tc["pos"]) == int(jc["pos"]) == 128
    for key in ("k", "v"):
        assert _rel(tc["layers"][key], jc["layers"][key]) < TOL


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_partial_prefill_and_decode_match_jax(weights, arch):
    """Prefill shorter than the cache (masked ``ref`` branch at a scalar
    position), then decode steps."""
    jcfg, tcfg = _cfgs(arch, attn_impl="flash")
    toks = _toks(tcfg, 3, (2, 40))
    jm, tm = jbuild(jcfg), build_model(tcfg)
    tp = params_from_jax(weights[arch], device="cpu")
    jc, tc = jm.init_cache(2, 64), tm.init_cache(2, 64, device="cpu")
    want, jc = jm.forward_with_cache(weights[arch], {"tokens": jnp.asarray(toks[:, :37])}, jc)
    got, tc = tm.forward_with_cache(tp, {"tokens": toks[:, :37]}, tc)
    assert _rel(got, want) < TOL
    for t in range(37, 40):
        want, jc = jm.decode_step(weights[arch], jnp.asarray(toks[:, t:t + 1]), jc)
        got, tc = tm.decode_step(tp, toks[:, t:t + 1], tc)
        assert got.shape == (2, 1, tcfg.vocab)
        assert _rel(got, want) < TOL, t
    assert int(tc["pos"]) == int(jc["pos"]) == 40
    for key in ("k", "v"):
        assert _rel(tc["layers"][key], jc["layers"][key]) < TOL


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_per_slot_positions_match_jax(weights, arch):
    """Per-slot ``cache["pos"]`` (continuous batching): a right-padded wave,
    then decode with each slot at its own position."""
    jcfg, tcfg = _cfgs(arch)
    toks = _toks(tcfg, 4, (3, 12))
    lens = np.array([12, 5, 9], np.int32)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    tp = params_from_jax(weights[arch], device="cpu")
    jc = dict(jm.init_cache(3, 32), pos=jnp.zeros(3, jnp.int32))
    tc = dict(tm.init_cache(3, 32, device="cpu"), pos=torch.zeros(3, dtype=torch.int32))
    want, jc = jm.forward_with_cache(weights[arch], {"tokens": jnp.asarray(toks)}, jc)
    got, tc = tm.forward_with_cache(tp, {"tokens": toks}, tc)
    assert _rel(got, want) < TOL
    jc["pos"], tc["pos"] = jnp.asarray(lens), torch.from_numpy(lens)
    nxt = _toks(tcfg, 5, (3, 1))
    for _ in range(3):
        want, jc = jm.decode_step(weights[arch], jnp.asarray(nxt), jc)
        got, tc = tm.decode_step(tp, nxt, tc)
        assert _rel(got, want) < TOL
        nxt = np.asarray(jnp.argmax(want[:, -1], axis=-1)).astype(np.int32)[:, None]
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == (lens + 3).tolist()


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decode_matches_forward(weights, arch):
    """As ``tests/test_models.py``: prefill S-1 tokens then decode the last
    one gives the full forward's last logits (and the reference's)."""
    jcfg, tcfg = _cfgs(arch)
    toks = _toks(tcfg, 6, (2, 32))
    tm = build_model(tcfg)
    tp = params_from_jax(weights[arch], device="cpu")
    full, _, _ = tm.forward(tp, {"tokens": toks})
    cache = tm.init_cache(2, 64, device="cpu")
    _, cache = tm.forward_with_cache(tp, {"tokens": toks[:, :-1]}, cache)
    step, _ = tm.decode_step(tp, toks[:, -1:], cache)
    assert _rel(step[:, -1], full[:, -1].numpy()) < TOL
    jm = jbuild(jcfg)
    _, jc = jm.forward_with_cache(weights[arch], {"tokens": jnp.asarray(toks[:, :-1])},
                                  jm.init_cache(2, 64))
    want, _ = jm.decode_step(weights[arch], jnp.asarray(toks[:, -1:]), jc)
    assert _rel(step, want) < TOL


def test_bf16_compute_matches_jax(weights):
    """The shipped numerics (bf16 activations over float32 parameters) on a
    reduced model: bf16 rounds at other places in the two frameworks, so
    the bound is bf16's (2^-8 relative per rounding, a few roundings deep)."""
    jcfg, tcfg = _cfgs("qwen3-8b", dtype="bfloat16", attn_impl="flash")
    toks = _toks(tcfg, 7, (2, 128))
    want, _, _ = jbuild(jcfg).forward(weights["qwen3-8b"], {"tokens": jnp.asarray(toks)})
    got, _, _ = build_model(tcfg).forward(params_from_jax(weights["qwen3-8b"], device="cpu"),
                                          {"tokens": toks})
    assert got.dtype == torch.bfloat16
    assert _rel(got, want.astype(jnp.float32)) < 5e-2
    top1 = np.mean(got.float().numpy().argmax(-1) == np.asarray(want.astype(jnp.float32)).argmax(-1))
    assert top1 > 0.9, top1


@pytest.mark.parametrize("arch", ["mamba2-130m", "arctic-480b", "minicpm3-4b", "whisper-medium"])
def test_unported_families_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(get_config(arch).reduced())


def test_default_device_needs_a_card():
    _, tcfg = _cfgs("internlm2-1.8b")
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(tcfg).init(0)
