"""The port's MoE block held against the JAX package's, on the CPU.

The reference's ``init_moe`` draws the weights (numpy leaves carried across
by ``params_from_jax``); tokens are numpy draws from a seed. Routing
(``expert_idx``, the ``keep`` mask, ``buf_slot``) is compared exactly: both
packages route in float32, and a near-tie that one package's sum order
flips would show as a routing mismatch, named in the assertion's message.
Outputs and aux losses: max |port - jax| / max |jax| < 1e-4 in float32
(``tests/test_torch_models.py`` argues the bound). The cases are those of
``tests/test_moe.py``, at its sizes.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig, MoEConfig as JMoEConfig  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs.base import ModelConfig, MoEConfig  # noqa: E402
from repro_torch.models import moe as tmoe, params_from_jax  # noqa: E402
from test_moe import dense_reference  # noqa: E402

TOL = 1e-4


def _cfgs(grouped=False, **moe_kw):
    kw = {**dict(n_experts=8, top_k=2, d_expert=16, capacity_factor=8.0), **moe_kw}
    common = dict(name="t", family="moe", n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                  d_ff=16, vocab=64, dtype="float32", param_dtype="float32",
                  moe_grouped=grouped)
    return (JModelConfig(moe=JMoEConfig(**kw), **common),
            ModelConfig(moe=MoEConfig(**kw), **common))


def _weights(jcfg, seed=0):
    jp = jax.device_get(jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32))
    return jp, params_from_jax(jp, device="cpu")


def _x(rng, shape):
    return rng.normal(0, 1, shape).astype(np.float32)


def _rel(got, want) -> float:
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-6))


def _routing_jax(jcfg, jp, x, grouped):
    """The reference's routing of ``x`` (B, S, d): expert ids, keep, buffer rows."""
    moe = jcfg.moe
    b, s, d = x.shape
    g, n = (b, s) if grouped else (1, b * s)
    cap = max(int(moe.capacity_factor * n * moe.top_k / moe.n_experts), moe.top_k)
    e_pad = jmoe._padded_experts(moe)
    _, _, idx, _ = jmoe._router(jcfg, jp, jnp.asarray(x).reshape(g, n, d))
    flat = idx.reshape(g, n * moe.top_k)
    order = jnp.argsort(flat, axis=1)
    sorted_e = jnp.take_along_axis(flat, order, axis=1)
    rank = jmoe._rank_within_expert(sorted_e)
    keep = rank < cap
    slot = jnp.where(keep, sorted_e * cap + rank, e_pad * cap)
    return np.asarray(idx), np.asarray(keep), np.asarray(slot), cap


def _routing_port(tcfg, tp, x, grouped):
    moe = tcfg.moe
    b, s, d = x.shape
    g, n = (b, s) if grouped else (1, b * s)
    cap = max(int(moe.capacity_factor * n * moe.top_k / moe.n_experts), moe.top_k)
    _, _, idx, _ = tmoe._router(tcfg, tp, torch.from_numpy(x).reshape(g, n, d))
    _, keep, slot = tmoe._dispatch(idx.reshape(g, n * moe.top_k), cap,
                                   tmoe._padded_experts(moe))
    return idx.numpy(), keep.numpy(), slot.numpy(), cap


@pytest.mark.parametrize("grouped", [False, True], ids=["global", "grouped"])
@pytest.mark.parametrize("cf", [8.0, 1.0, 0.5], ids=["dropless", "cf1", "cf0.5"])
def test_routing_matches_reference_exactly(rng, grouped, cf):
    jcfg, tcfg = _cfgs(grouped, capacity_factor=cf)
    jp, tp = _weights(jcfg)
    x = _x(rng, (2, 32, 32))
    want = _routing_jax(jcfg, jp, x, grouped)
    got = _routing_port(tcfg, tp, x, grouped)
    assert got[3] == want[3]
    for name, g, w in zip(("expert_idx", "keep", "buf_slot"), got[:3], want[:3]):
        bad = np.argwhere(g != w)
        assert bad.size == 0, f"{name} differs at {bad[:5].tolist()} (a float32 router " \
                              f"near-tie flipped by sum order, or a dispatch fault)"


@pytest.mark.parametrize("grouped", [False, True], ids=["global", "grouped"])
@pytest.mark.parametrize("cf", [8.0, 1.0, 0.5], ids=["dropless", "cf1", "cf0.5"])
def test_moe_block_matches_reference(rng, grouped, cf):
    jcfg, tcfg = _cfgs(grouped, capacity_factor=cf)
    jp, tp = _weights(jcfg)
    x = _x(rng, (2, 32, 32))
    want, jaux = jmoe.moe_block(jcfg, jp, jnp.asarray(x))
    got, aux = tmoe.moe_block(tcfg, tp, torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert _rel(got, want) < TOL
    assert set(aux) == set(jaux) == {"moe_aux_loss", "router_z_loss"}
    for k in aux:
        assert abs(float(aux[k]) - float(jaux[k])) <= TOL * abs(float(jaux[k])), k


@pytest.mark.parametrize("grouped", [False, True], ids=["global", "grouped"])
def test_capacity_drops_equal_reference(rng, grouped):
    """With capacity_factor 1 on 64 tokens, some assignments drop: the same
    ones in both packages, and a dropped assignment contributes nothing."""
    jcfg, tcfg = _cfgs(grouped, capacity_factor=1.0)
    jp, tp = _weights(jcfg)
    x = _x(rng, (1, 64, 32))
    _, jkeep, _, _ = _routing_jax(jcfg, jp, x, grouped)
    _, keep, _, _ = _routing_port(tcfg, tp, x, grouped)
    assert (~keep).sum() == (~jkeep).sum() > 0
    assert np.array_equal(keep, jkeep)
    got, _ = tmoe.moe_block(tcfg, tp, torch.from_numpy(x))
    want, _ = jmoe.moe_block(jcfg, jp, jnp.asarray(x))
    assert bool(torch.isfinite(got).all()) and _rel(got, want) < TOL


def test_padding_experts_never_routed(rng):
    """Padded experts get -1e30 logits and probability 0: with NaN weights
    there, the output stays finite, and no id reaches them."""
    jcfg, tcfg = _cfgs(n_experts=6, pad_experts_to=8)
    jp, tp = _weights(jcfg)
    assert tp["router"].shape == (32, 8)
    x = _x(rng, (2, 16, 32))
    idx, _, _, _ = _routing_port(tcfg, tp, x, False)
    assert idx.max() < 6
    tp["w_gate"][6:] = float("nan")
    got, _ = tmoe.moe_block(tcfg, tp, torch.from_numpy(x))
    assert bool(torch.isfinite(got).all())
    want, _ = jmoe.moe_block(jcfg, jp, jnp.asarray(x))
    assert _rel(got, want) < TOL


def test_shared_and_dense_parallel_paths(rng):
    jcfg, tcfg = _cfgs(n_shared=2, dense_ff_parallel=16)
    jp, tp = _weights(jcfg)
    assert set(tp) == {"router", "w_gate", "w_up", "w_down", "shared", "dense"}
    x = _x(rng, (1, 8, 32))
    want, _ = jmoe.moe_block(jcfg, jp, jnp.asarray(x))
    got, _ = tmoe.moe_block(tcfg, tp, torch.from_numpy(x))
    assert _rel(got, want) < TOL
    # both extra paths are live: zeroing either changes the output
    for key in ("shared", "dense"):
        zeroed = dict(tp, **{key: {k: v * 0 for k, v in tp[key].items()}})
        other, _ = tmoe.moe_block(tcfg, zeroed, torch.from_numpy(x))
        assert not torch.allclose(other, got), key


def test_dropless_matches_compute_all_experts(rng):
    """``tests/test_moe.py``'s compute-all-experts reference (no dispatch,
    no capacity) on the port's block."""
    jcfg, tcfg = _cfgs()
    jp, tp = _weights(jcfg)
    x = _x(rng, (1, 24, 32))
    got, _ = tmoe.moe_block(tcfg, tp, torch.from_numpy(x))
    want = dense_reference(jcfg, jp, jnp.asarray(x[0]))
    assert np.allclose(got[0].numpy(), want, atol=1e-4)


def test_load_balance_loss_ordering(rng):
    """Collapsed routing has a larger aux loss than the spread one."""
    jcfg, tcfg = _cfgs()
    _, tp = _weights(jcfg)
    x = torch.from_numpy(_x(rng, (1, 128, 32)))
    _, aux_u = tmoe.moe_block(tcfg, tp, x)
    r = tp["router"].clone()
    r[:, 0] += 100.0
    _, aux_c = tmoe.moe_block(tcfg, dict(tp, router=r), x)
    assert float(aux_c["moe_aux_loss"]) > float(aux_u["moe_aux_loss"])


def test_top_k_takes_the_lowest_index_on_ties():
    """``lax.top_k`` keeps the lowest index among equal values; so does the port's."""
    probs = np.array([[0.1, 0.3, 0.3, 0.0, 0.3], [0.25, 0.25, 0.25, 0.25, 0.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = tmoe.top_k(torch.from_numpy(probs), 3)
    assert ti.tolist() == np.asarray(ji).tolist() == [[1, 2, 4], [0, 1, 2]]
    assert np.array_equal(tv.numpy(), np.asarray(jv))


def test_stable_sort_keeps_token_order_within_an_expert():
    """Within an expert, assignments keep token order, so the ones past
    capacity are the last tokens: the reference's stable ``argsort``."""
    flat = torch.tensor([[3, 1, 3, 3, 0, 1, 3]])
    order, keep, slot = tmoe._dispatch(flat, capacity=2, e_pad=4)
    assert order.tolist() == [[4, 1, 5, 0, 2, 3, 6]]
    assert keep.tolist() == [[True, True, True, True, True, False, False]]
    assert slot.tolist() == [[0, 2, 3, 6, 7, 8, 8]]


def test_bf16_experts_with_float32_router(rng):
    """Arctic's mix: bf16 experts, a float32 router; the block computes in
    the activations' dtype and routes in float32, as the reference."""
    jcfg, tcfg = _cfgs()
    jp = jax.device_get(jmoe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.bfloat16))
    tp = params_from_jax(jp, device="cpu")
    assert tp["router"].dtype == torch.float32 and tp["w_gate"].dtype == torch.bfloat16
    x = _x(rng, (1, 16, 32))
    jcfg16 = dataclasses.replace(jcfg, dtype="bfloat16")
    tcfg16 = dataclasses.replace(tcfg, dtype="bfloat16")
    want, _ = jmoe.moe_block(jcfg16, jp, jnp.asarray(x, jnp.bfloat16))
    got, _ = tmoe.moe_block(tcfg16, tp, torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    # bf16 rounds at other places in the two frameworks (2^-8 a rounding)
    assert _rel(got.float(), np.asarray(want.astype(jnp.float32))) < 3e-2
