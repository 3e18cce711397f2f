"""The port's flash-attention op held against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages. JAX runs
as its own tests run it on the CPU: the Pallas kernel in interpret mode
(``use_pallas=True``) and the jnp oracle (``use_pallas=False``). The port
runs ``ops.attention`` on CPU tensors, i.e. its plain version inside the
kernel's framing (GQA, error contract). Tolerances are the
reference's own (``tests/test_kernels.py``): 2e-5 in float32 (sum order),
3e-2 in bf16 (the kernel accumulates P.V in float32, the oracle rounds P to
bf16 first). The CUDA kernel is held against the same plain version in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import attention as jattention  # noqa: E402
from repro_torch.kernels.flash_attention import attention, attention_plain, ref  # noqa: E402

SHAPES = [
    (2, 4, 4, 128, 128, 64, True),
    (1, 8, 2, 256, 256, 64, True),    # GQA
    (2, 2, 2, 128, 128, 32, False),   # non-causal
    (1, 4, 4, 128, 384, 64, True),    # decode-aligned rectangular
    (1, 2, 2, 1, 128, 64, True),      # single-token decode
    (1, 2, 2, 100, 128, 64, True),    # ragged q (front padding)
]


def _qkv(rng, b, hq, hkv, sq, sk, d, dtype=np.float32):
    return (rng.normal(0, 1, (b, hq, sq, d)).astype(dtype),
            rng.normal(0, 1, (b, hkv, sk, d)).astype(dtype),
            rng.normal(0, 1, (b, hkv, sk, d)).astype(dtype))


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", SHAPES)
def test_attention_matches_jax_f32(rng, b, hq, hkv, sq, sk, d, causal):
    q, k, v = _qkv(rng, b, hq, hkv, sq, sk, d)
    got = attention(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for use_pallas in (False, True):
        want = np.asarray(jattention(jq, jk, jv, causal=causal, use_pallas=use_pallas))
        assert got.shape == want.shape == (b, hq, sq, d)
        assert float(np.max(np.abs(got - want))) < 2e-5, use_pallas


def test_attention_matches_jax_bf16(rng):
    q, k, v = _qkv(rng, 1, 2, 2, 128, 128, 64)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    for use_pallas in (False, True):
        want = np.asarray(jattention(jq, jk, jv, causal=True,
                                     use_pallas=use_pallas).astype(jnp.float32))
        assert float(np.max(np.abs(got.float().numpy() - want))) < 3e-2, use_pallas


def test_plain_version_matches_jax_oracle(rng):
    """``attention_ref`` alone (no framing) against ``attention_ref`` of JAX."""
    from repro.kernels.flash_attention import attention_ref as jref

    q, k, v = _qkv(rng, 1, 3, 3, 70, 128, 32)
    for causal in (True, False):
        got = ref.attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()
        want = np.asarray(jref(*map(jnp.asarray, (q, k, v)), causal=causal))
        assert float(np.max(np.abs(got - want))) < 2e-5


def test_plain_and_dispatch_agree_on_cpu(rng):
    q, k, v = map(torch.from_numpy, _qkv(rng, 1, 4, 2, 100, 256, 64))
    assert torch.equal(attention(q, k, v), attention_plain(q, k, v))


@pytest.mark.parametrize("sq,sk", [(100, 128), (1, 256), (130, 384)])
def test_front_pad_changes_no_real_row(rng, sq, sk):
    """The reference front-pads q to its 128-row block and slices the pad
    off; the port does not pad, since the diagonal ``c <= r + (Sk - Sq)``
    puts real row ``i`` on padded row ``i + pad`` with the same keys. The
    matrix products see other row counts, so they may sum in another order:
    1e-6 allows for that and for nothing else."""
    q, k, v = map(torch.from_numpy, _qkv(rng, 1, 4, 2, sq, sk, 32))
    pad = (-sq) % 128
    padded = ref.attention_ref(torch.nn.functional.pad(q, (0, 0, pad, 0)), k, v)[:, :, pad:]
    assert float((attention(q, k, v) - padded).abs().max()) < 1e-6


@pytest.mark.parametrize("case", ["ragged_k", "ragged_q_noncausal", "bad_group"])
def test_error_contract(rng, case):
    if case == "ragged_k":
        q, k, v = _qkv(rng, 1, 2, 2, 128, 100, 32)
        kw = {"causal": True}
    elif case == "ragged_q_noncausal":
        q, k, v = _qkv(rng, 1, 2, 2, 100, 128, 32)
        kw = {"causal": False}
    else:
        q, k, v = _qkv(rng, 1, 3, 2, 128, 128, 32)
        kw = {"causal": True}
    with pytest.raises(ValueError):
        attention(*map(torch.from_numpy, (q, k, v)), **kw)
    if case != "bad_group":  # the reference asserts on the group instead
        with pytest.raises(ValueError):
            jattention(*map(jnp.asarray, (q, k, v)), use_pallas=True, **kw)
