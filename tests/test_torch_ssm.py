"""The port's Mamba2/SSD block held against the JAX package's, on the CPU.

Inputs are numpy draws from a seed; block weights come from the
reference's ``init_ssm`` through ``params_from_jax``. Tolerance, float32:
max |port - jax| / max |jax| < 1e-4 (``tests/test_torch_models.py``
argues the bound); against ``tests/test_ssm.py``'s naive recurrence, that
file's own 1e-4 absolute.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import params_from_jax, ssm as tssm  # noqa: E402
from test_ssm import naive_recurrence  # noqa: E402

TOL = 1e-4


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-6))


def _scan_inputs(rng, bsz, L, h, p, n):
    return (rng.normal(0, 1, (bsz, L, h, p)).astype(np.float32),
            rng.uniform(0.001, 0.1, (bsz, L, h)).astype(np.float32),
            -rng.uniform(0.5, 2.0, h).astype(np.float32),
            rng.normal(0, 1, (bsz, L, n)).astype(np.float32),
            rng.normal(0, 1, (bsz, L, n)).astype(np.float32))


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("L,chunk", [(32, 8), (64, 16), (48, 48), (96, 32)])
def test_ssd_scan_matches_reference_and_recurrence(rng, L, chunk):
    args = _scan_inputs(rng, 2, L, 3, 4, 8)
    y, s = tssm.ssd_scan(*_t(args), chunk=chunk)
    jy, js = jssm.ssd_scan(*[jnp.asarray(a) for a in args], chunk=chunk)
    assert _rel(y, jy) < TOL and _rel(s, js) < TOL
    y_ref, s_ref = naive_recurrence(*args)
    assert np.allclose(y.numpy(), y_ref, atol=1e-4)
    assert np.allclose(s.numpy(), s_ref, atol=1e-4)


def test_ssd_scan_init_state_continuation(rng):
    """Two calls, the second from the first's final state, equal one call,
    and each equals the reference's call."""
    L, chunk, half = 64, 16, 32
    args = _scan_inputs(rng, 1, L, 2, 4, 8)
    x, dt, a, b, c = _t(args)
    y_full, s_full = tssm.ssd_scan(x, dt, a, b, c, chunk=chunk)
    y1, s1 = tssm.ssd_scan(x[:, :half], dt[:, :half], a, b[:, :half], c[:, :half], chunk=chunk)
    y2, s2 = tssm.ssd_scan(x[:, half:], dt[:, half:], a, b[:, half:], c[:, half:],
                           chunk=chunk, init_state=s1)
    assert torch.allclose(y_full[:, half:], y2, atol=1e-4)
    assert torch.allclose(s_full, s2, atol=1e-4)
    jx, jdt, ja, jb, jc = (jnp.asarray(t) for t in args)
    _, js1 = jssm.ssd_scan(jx[:, :half], jdt[:, :half], ja, jb[:, :half], jc[:, :half],
                           chunk=chunk)
    jy2, js2 = jssm.ssd_scan(jx[:, half:], jdt[:, half:], ja, jb[:, half:], jc[:, half:],
                             chunk=chunk, init_state=js1)
    assert _rel(y2, jy2) < TOL and _rel(s2, js2) < TOL


def test_ssd_scan_bf16_products(rng):
    """``matmul_dtype=bfloat16`` (mamba2-130m, zamba2): the intra-chunk
    operands round to bf16 and the products come out in float32. Against the
    reference's same path: both round the same float32 operands, so they
    agree to float32 sum order, except where an intermediate float32 value
    one ulp apart rounds to neighbouring bf16 values (2^-8 of one term of a
    sum of ``chunk``): 1e-3. Against the reference's float32 outputs: the
    bf16 rounding of three operands, 3 x 2^-8 relative of each term: 2e-2."""
    args = _scan_inputs(rng, 2, 64, 3, 4, 8)
    y, s = tssm.ssd_scan(*_t(args), chunk=16, matmul_dtype=torch.bfloat16)
    assert y.dtype == torch.float32
    jy16, _ = jssm.ssd_scan(*[jnp.asarray(a) for a in args], chunk=16,
                            matmul_dtype=jnp.bfloat16)
    jy32, js32 = jssm.ssd_scan(*[jnp.asarray(a) for a in args], chunk=16)
    assert _rel(y, jy16) < 1e-3
    assert _rel(y, jy32) < 2e-2
    assert _rel(s, js32) < TOL      # the state path stays float32
    assert _rel(y, jy32) > 1e-5     # and the products did round


def test_ssd_scan_needs_whole_chunks(rng):
    args = _scan_inputs(rng, 1, 40, 2, 4, 8)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tssm.ssd_scan(*_t(args), chunk=16)


def _block(name="mamba2-130m", chunk=8):
    jcfg, tcfg = jget_config(name).reduced(), get_config(name).reduced()
    jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm, chunk=chunk))
    tcfg = dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm, chunk=chunk))
    jp = jax.device_get(jssm.init_ssm(jax.random.PRNGKey(0), jcfg, jnp.float32))
    return jcfg, tcfg, jp, params_from_jax(jp, device="cpu")


def test_ssm_forward_and_prefill_cache_match_reference(rng):
    jcfg, tcfg, jp, tp = _block()
    x = rng.normal(0, 0.5, (2, 24, tcfg.d_model)).astype(np.float32)
    want, _ = jssm.ssm_forward(jcfg, jp, jnp.asarray(x))
    got, none = tssm.ssm_forward(tcfg, tp, torch.from_numpy(x))
    assert none is None and _rel(got, want) < TOL
    # prefill 16 tokens into a cache, then 8 more from it (carry-in tails and state)
    jc = jssm.init_ssm_cache(jcfg, 2, jnp.float32)
    tc = tssm.init_ssm_cache(tcfg, 2, torch.float32, "cpu")
    for lo, hi in ((0, 16), (16, 24)):
        want, jc = jssm.ssm_forward(jcfg, jp, jnp.asarray(x[:, lo:hi]), cache=jc)
        got, tc2 = tssm.ssm_forward(tcfg, tp, torch.from_numpy(x[:, lo:hi]), cache=tc)
        assert tc2 is tc and _rel(got, want) < TOL
        for k in jc:
            assert _rel(tc[k], jc[k]) < TOL, k


def test_ssm_decode_step_matches_reference_and_forward(rng):
    """Token-by-token ``ssm_decode_step`` equals the reference's steps and
    the port's own full-sequence ``ssm_forward`` (``tests/test_ssm.py``)."""
    jcfg, tcfg, jp, tp = _block()
    x = rng.normal(0, 0.5, (2, 24, tcfg.d_model)).astype(np.float32)
    full, _ = tssm.ssm_forward(tcfg, tp, torch.from_numpy(x))
    jc = jssm.init_ssm_cache(jcfg, 2, jnp.float32)
    tc = tssm.init_ssm_cache(tcfg, 2, torch.float32, "cpu")
    outs = []
    for t in range(x.shape[1]):
        want, jc = jssm.ssm_decode_step(jcfg, jp, jnp.asarray(x[:, t:t + 1]), jc)
        got, tc = tssm.ssm_decode_step(tcfg, tp, torch.from_numpy(x[:, t:t + 1]), tc)
        assert got.shape == (2, 1, tcfg.d_model) and _rel(got, want) < TOL, t
        outs.append(got[:, 0])
    for k in jc:
        assert _rel(tc[k], jc[k]) < TOL, k
    assert torch.allclose(full, torch.stack(outs, dim=1), atol=2e-4)


@pytest.mark.parametrize("name", ["mamba2-130m", "zamba2-1.2b", "spatial-lm"])
def test_fixed_draws_equal_reference(name):
    """``dt_bias`` and ``D`` are the reference's leaves bit for bit, from any
    seed; ``A_log`` is the correctly rounded log of the same float32 draws,
    within one ulp of XLA's float32 log (not correctly rounded)."""
    cfg = get_config(name)
    jp = jssm.init_ssm(jax.random.PRNGKey(0), jget_config(name), jnp.float32)
    gen = torch.Generator()
    gen.manual_seed(7)
    tp = tssm.init_ssm(gen, cfg, torch.float32, stack=(2,))
    h = tssm.ssm_dims(cfg)[1]
    assert tp["dt_bias"].shape == (2, h)
    for k in ("dt_bias", "D"):
        want = np.asarray(jp[k]).view(np.int32)
        assert all(np.array_equal(tp[k][i].numpy().view(np.int32), want) for i in range(2)), k
    ulps = np.abs(tp["A_log"].numpy().view(np.int32).astype(np.int64)
                  - np.asarray(jp["A_log"]).view(np.int32))
    assert ulps.max() <= 1
    a = np.random.RandomState(1).uniform(1, 16, h).astype(np.float32)
    assert np.array_equal(tp["A_log"][0].numpy(), np.log(a.astype(np.float64)).astype(np.float32))


def test_softplus_is_logaddexp():
    """No linear cut-over at 20, as ``jax.nn.softplus``."""
    x = np.array([-50, -3, 0, 3, 19.5, 20, 20.5, 30, 80], np.float32)
    got = tssm.softplus(torch.from_numpy(x)).numpy()
    assert np.allclose(got, np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6, atol=0)
