"""The port's LM stack held against the JAX package's, on the CPU, for all
eleven configs (every family: dense, MLA, MoE, SSM, hybrid, encoder-decoder,
vision-language).

Both packages compute with the same weights: the reference's ``model.init``
draws them and :func:`repro_torch.models.params_from_jax` carries them
across. Tokens, audio frames and image patches are made with numpy from a
seed. JAX's ``flash`` runs its Pallas kernel in interpret mode, as its own
tests do; the port's ``flash`` runs its plain version on CPU tensors.

Configs: each one's ``reduced()`` variant; qwen3-8b with ``n_kv_heads=2``
(GQA with 2 query heads per kv head, and qk-norm; ``reduced()`` alone gives
Hq = Hkv = 4). Tolerance: max |port - jax| / max |jax| below 1e-4 in
float32. The two packages take the same float32 sums in another order
(matmul blocking, softmax, norm and scan reductions), which moves logits of
magnitude ~1 in the 6th-7th digit; 1e-4 leaves room for that and nothing
else. MoE routing is decided in float32 by both; a flipped near-tie would
show far beyond 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS, get_config  # noqa: E402
from repro_torch.models import build_model, flatten_with_paths, params_from_jax  # noqa: E402

TOL = 1e-4
ARCHS = {name: {} for name in TARCHS}
ARCHS["qwen3-8b"] = {"n_kv_heads": 2}
FAMILIES = {get_config(n).family for n in ARCHS}


def _cfgs(arch, **kw):
    over = dict(ARCHS[arch], **kw)
    return (dataclasses.replace(jget_config(arch).reduced(), **over),
            dataclasses.replace(get_config(arch).reduced(), **over))


@pytest.fixture(scope="module")
def weights():
    """Reference weights per arch (numpy leaves), drawn once per module on first use."""
    cache = {}

    class _W(dict):
        def __missing__(self, arch):
            jcfg, _ = _cfgs(arch)
            cache[arch] = jax.device_get(jbuild(jcfg).init(jax.random.PRNGKey(0)))
            self[arch] = cache[arch]
            return cache[arch]

    return _W()


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-6))


def _toks(cfg, seed, shape):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _batch(cfg, seed, b, s, frames=None):
    """``s`` positions: tokens, with a vlm's patches in front of them and an
    encdec's frames (``frames`` long, default s // downsample) beside them."""
    rng = np.random.default_rng(seed)
    n_tok = s - cfg.vision_tokens if cfg.family == "vlm" else s
    out = {"tokens": rng.integers(0, cfg.vocab, (b, n_tok)).astype(np.int32)}
    if cfg.family == "encdec":
        n = frames or s // cfg.frontend_downsample
        out["frames"] = rng.normal(0, 1, (b, n, cfg.frontend_dim or cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.normal(0, 1, (b, cfg.vision_tokens, cfg.frontend_dim)).astype(np.float32)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _flat(tree):
    """``{path: leaf}`` of a nested dict, in the port's one leaf order."""
    return dict(flatten_with_paths(tree))


def _caches_close(tc, jc):
    tf, jf = _flat({k: v for k, v in tc.items() if k != "pos"}), \
        _flat({k: v for k, v in jc.items() if k != "pos"})
    assert set(tf) == set(jf)
    for k in jf:
        assert _rel(tf[k], jf[k]) < TOL, k
    assert np.array_equal(np.asarray(tc["pos"]), np.asarray(jc["pos"]))


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


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_config_builds(arch):
    """``build_model`` takes every published config. At the reduced size
    with bf16 parameters, the port's ``init`` gives the reference's tree
    (keys, stacked shapes, and dtypes: the router, ``dt_bias``, ``A_log``
    and ``D`` stay float32 beside bf16 leaves), and ``params_from_jax``
    carries the reference's tree across bit for bit in the same dtypes."""
    model = build_model(get_config(arch))
    assert model.cfg.name == arch and callable(model.loss)
    jcfg, tcfg = _cfgs(arch, param_dtype="bfloat16")
    theirs = _flat(jax.device_get(jbuild(jcfg).init(jax.random.PRNGKey(0))))
    mine = _flat(build_model(tcfg).init(0, device="cpu"))
    assert set(mine) == set(theirs)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for k, v in mine.items():
        assert tuple(v.shape) == theirs[k].shape and v.dtype == dtypes[theirs[k].dtype.name], k
    carried = _flat(params_from_jax({"t": {k: v for k, v in theirs.items()}}, device="cpu"))
    for k, v in theirs.items():
        got = carried["t/" + k]
        assert got.dtype == mine[k].dtype, k
        bits = np.int16 if v.dtype.name == "bfloat16" else np.int32
        assert np.array_equal(got.view({np.int16: torch.int16, np.int32: torch.int32}[bits])
                              .numpy(), np.asarray(v).view(bits)), k
    assert FAMILIES == {"dense", "moe", "ssm", "hybrid", "encdec", "vlm"}


def test_bf16_leaves_carry_across_bit_for_bit(rng):
    a = jnp.asarray(rng.normal(0, 3, (5, 7)).astype(np.float32)).astype(jnp.bfloat16)
    got = params_from_jax({"w": {"x": jax.device_get(a)}}, device="cpu")["w"]["x"]
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(), np.asarray(a).view(np.int16))


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("impl", ["ref", "blocked", "flash"])
def test_forward_matches_jax(weights, arch, impl):
    """128 positions (whisper: 128 frames too, so its non-causal encoder
    runs the flash path on whole 128-row blocks)."""
    jcfg, tcfg = _cfgs(arch, attn_impl=impl)
    batch = _batch(tcfg, 1, 2, 128, frames=128)
    want, jaux, jmask = jbuild(jcfg).forward(weights[arch], _j(batch))
    got, aux, mask = build_model(tcfg).forward(params_from_jax(weights[arch], device="cpu"),
                                               batch)
    assert got.dtype == torch.float32
    assert _rel(got, want) < TOL
    assert set(aux) == set(jaux) == ({"moe_aux_loss", "router_z_loss"}
                                     if tcfg.family == "moe" else set())
    for k in aux:
        assert abs(float(aux[k]) - float(jaux[k])) <= TOL * abs(float(jaux[k])), k
    assert (mask is None) == (jmask is None) == (tcfg.family != "vlm")
    if mask is not None:
        assert np.array_equal(mask.numpy(), np.asarray(jmask))


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("ce_impl", ["gather", "onehot"])
def test_loss_matches_jax(weights, arch, ce_impl):
    """Next-token cross entropy with labels shifted by one (-1 over a vlm's
    patches), plus the MoE aux losses; every metric against the reference's."""
    jcfg, tcfg = _cfgs(arch, ce_impl=ce_impl)
    batch = _batch(tcfg, 8, 2, 64)
    want, jmet = jbuild(jcfg).loss(weights[arch], _j(batch))
    got, met = build_model(tcfg).loss(params_from_jax(weights[arch], device="cpu"), batch)
    assert set(met) == set(jmet)
    assert abs(float(got) - float(want)) <= TOL * abs(float(want))
    n_tok = batch["tokens"].shape[1] - 1
    assert int(met["tokens"]) == int(jmet["tokens"]) == 2 * n_tok
    for k in met:
        assert abs(float(met[k]) - float(jmet[k])) <= TOL * max(abs(float(jmet[k])), 1e-6), k


def test_loss_ignores_negative_labels_and_clamps_the_count():
    """Explicit labels: < 0 are ignored; all ignored gives loss 0 over count 1."""
    from repro.models.layers import cross_entropy_loss as jce
    from repro_torch.models.layers import cross_entropy_loss as tce

    rng = np.random.default_rng(9)
    logits = rng.normal(0, 2, (2, 5, 11)).astype(np.float32)
    labels = rng.integers(-1, 11, (2, 5)).astype(np.int32)
    for impl in ("gather", "onehot"):
        for lab in (labels, np.full_like(labels, -1)):
            want, wc = jce(jnp.asarray(logits), jnp.asarray(lab), impl=impl)
            got, gc = tce(torch.from_numpy(logits), torch.from_numpy(lab), impl=impl)
            assert int(gc) == int(wc) == max(int((lab >= 0).sum()), 1)
            assert abs(float(got) - float(want)) <= 1e-6 * max(abs(float(want)), 1.0)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_full_capacity_prefill_matches_jax(weights, arch):
    """Prefill of exactly the cache's capacity: the flash branch (whisper
    with 128 frames, whose K/V replace the 64-row cross cache; pixtral with
    its patches in front of the tokens)."""
    jcfg, tcfg = _cfgs(arch, attn_impl="flash")
    batch = _batch(tcfg, 2, 2, 128, frames=128)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    want, jc = jm.forward_with_cache(weights[arch], _j(batch), jm.init_cache(2, 128))
    got, tc = tm.forward_with_cache(params_from_jax(weights[arch], device="cpu"),
                                    batch, tm.init_cache(2, 128, device="cpu"))
    assert _rel(got, want) < TOL
    assert int(tc["pos"]) == int(jc["pos"]) == 128
    _caches_close(tc, jc)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_partial_prefill_and_decode_match_jax(weights, arch):
    """Prefill shorter than the cache (the masked ``ref`` branch at a scalar
    position), a second prefill continuing from it (SSM: carry-in state and
    conv tails; whisper and pixtral: text only), then decode steps."""
    jcfg, tcfg = _cfgs(arch, attn_impl="flash")
    first = _batch(tcfg, 3, 2, 32, frames=128)
    toks = _toks(tcfg, 13, (2, 8))
    jm, tm = jbuild(jcfg), build_model(tcfg)
    tp = params_from_jax(weights[arch], device="cpu")
    jc, tc = jm.init_cache(2, 64), tm.init_cache(2, 64, device="cpu")
    want, jc = jm.forward_with_cache(weights[arch], _j(first), jc)
    got, tc = tm.forward_with_cache(tp, first, tc)
    assert _rel(got, want) < TOL
    want, jc = jm.forward_with_cache(weights[arch], {"tokens": jnp.asarray(toks[:, :5])}, jc)
    got, tc = tm.forward_with_cache(tp, {"tokens": toks[:, :5]}, tc)
    assert _rel(got, want) < TOL
    for t in range(5, 8):
        want, jc = jm.decode_step(weights[arch], jnp.asarray(toks[:, t:t + 1]), jc)
        got, tc = tm.decode_step(tp, toks[:, t:t + 1], tc)
        assert got.shape == (2, 1, tcfg.vocab)
        assert _rel(got, want) < TOL, t
    assert int(tc["pos"]) == int(jc["pos"]) == 40
    _caches_close(tc, jc)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_per_slot_positions_match_jax(weights, arch):
    """Per-slot ``cache["pos"]`` (continuous batching): a right-padded wave,
    then decode with each slot at its own position (text only, as the
    server sends)."""
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
    _caches_close(tc, jc)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decode_matches_forward(weights, arch):
    """As ``tests/test_models.py``: prefill S-1 positions then decode the
    last token gives the full forward's last logits (and the reference's).
    The MoE configs run dropless (capacity_factor = n_experts), as
    ``test_moe_decode_dropless`` does: with drops, a forward over S tokens
    and a decode over 1 have different capacities."""
    over = {}
    if get_config(arch).moe is not None:
        moe = get_config(arch).reduced().moe
        over["moe"] = dataclasses.replace(moe, capacity_factor=float(moe.n_experts))
    jcfg, tcfg = _cfgs(arch, **over)
    jp = weights[arch]
    batch = _batch(tcfg, 6, 2, 32)
    toks = batch["tokens"]
    tm = build_model(tcfg)
    tp = params_from_jax(jp, device="cpu")
    full, _, _ = tm.forward(tp, batch)
    cache = tm.init_cache(2, 64, device="cpu")
    _, cache = tm.forward_with_cache(tp, dict(batch, tokens=toks[:, :-1]), cache)
    step, _ = tm.decode_step(tp, toks[:, -1:], cache)
    assert _rel(step[:, -1], full[:, -1].numpy()) < TOL
    jm = jbuild(jcfg)
    _, jc = jm.forward_with_cache(jp, _j(dict(batch, tokens=toks[:, :-1])), jm.init_cache(2, 64))
    want, _ = jm.decode_step(jp, jnp.asarray(toks[:, -1:]), jc)
    assert _rel(step, want) < TOL


def test_whisper_prefill_with_and_without_frames(weights):
    """With frames, prefill replaces the cross cache by the encoder's K/V at
    the frames' length (24, not the preallocated max_len // 2 = 32 rows);
    without frames the zero cross cache stays (cross-attention over zeros:
    how the reference's server runs whisper), in both packages."""
    jcfg, tcfg = _cfgs("whisper-medium")
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = weights["whisper-medium"]
    tp = params_from_jax(jp, device="cpu")
    batch = _batch(tcfg, 10, 2, 16, frames=24)
    shape = (tcfg.n_layers, 2, 24, tcfg.n_heads, tcfg.resolved_head_dim)
    want, jc = jm.forward_with_cache(jp, _j(batch), jm.init_cache(2, 64))
    got, tc = tm.forward_with_cache(tp, batch, tm.init_cache(2, 64, device="cpu"))
    assert tc["cross"]["k"].shape == jc["cross"]["k"].shape == shape
    assert _rel(got, want) < TOL
    _caches_close(tc, jc)
    text = {"tokens": batch["tokens"]}
    want, jc = jm.forward_with_cache(jp, _j(text), jm.init_cache(2, 64))
    got, tc = tm.forward_with_cache(tp, text, tm.init_cache(2, 64, device="cpu"))
    assert tc["cross"]["k"].shape == (tcfg.n_layers, 2, 32, tcfg.n_heads, tcfg.resolved_head_dim)
    assert not tc["cross"]["k"].any() and not tc["cross"]["v"].any()
    assert _rel(got, want) < TOL
    _caches_close(tc, jc)


def test_zamba2_sites_match_jax():
    """Four layers with the shared block every second one: two sites, each
    with its own KV cache (written at layers 1 and 3), from one weight set."""
    jcfg, tcfg = _cfgs("zamba2-1.2b", n_layers=4)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tp = params_from_jax(jp, device="cpu")
    assert "shared_attn" in tp and tp["shared_attn"]["attn"]["wq"].dim() == 2
    toks = _toks(tcfg, 11, (2, 20))
    jc, tc = jm.init_cache(2, 32), tm.init_cache(2, 32, device="cpu")
    assert tc["sites"]["k"].shape == (2, 2, 32, tcfg.n_kv_heads, tcfg.resolved_head_dim)
    want, jc = jm.forward_with_cache(jp, {"tokens": jnp.asarray(toks[:, :16])}, jc)
    got, tc = tm.forward_with_cache(tp, {"tokens": toks[:, :16]}, tc)
    assert _rel(got, want) < TOL
    for t in range(16, 20):
        want, jc = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]), jc)
        got, tc = tm.decode_step(tp, toks[:, t:t + 1], tc)
        assert _rel(got, want) < TOL, t
    _caches_close(tc, jc)
    k = tc["sites"]["k"]
    assert bool(k[:, :, :20].any(dim=(1, 2, 3, 4)).all()) and not k[:, :, 20:].any()
    assert not torch.equal(k[0], k[1])


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


def test_default_device_needs_a_card():
    _, tcfg = _cfgs("internlm2-1.8b")
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(tcfg).init(0)
