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


def test_tpu_kernel_zeroes_rows_of_skipped_blocks(rng):
    """The reference's tile schedule on rows that see no key (Sq > Sk): its
    Pallas kernel front-pads q to 128-row blocks, and a block whose every
    key tile lies above the diagonal is skipped and written as 0. Here
    (Sq = 200, Sk = 128) the first block holds real rows -56..71, exactly
    the rows that see no key; the port's sm90 kernel lays out its query
    tiles the same way (held on the card by ``tests/test_torch_cuda.py``).
    The rows that see keys agree with the port's plain version."""
    q, k, v = _qkv(rng, 1, 2, 2, 200, 128, 64)
    want = np.asarray(jattention(*map(jnp.asarray, (q, k, v)), causal=True, use_pallas=True))
    assert np.all(want[:, :, :72] == 0)
    plain = attention_plain(*map(torch.from_numpy, (q, k, v)), causal=True).numpy()
    assert float(np.max(np.abs(want[:, :, 72:] - plain[:, :, 72:]))) < 2e-5


# ------------------------------------------- the bf16 kernel's tolerance model
LOG2E = 1.4426950408889634


def _emulate_sm90(q, k, v, causal=True, shift=0, rescale=True):
    """The rounding of ``csrc/flash_attention_sm90.cu`` in plain torch, on
    float32 tensors holding bf16 values: logits in float32, online softmax
    over 128-key tiles in the log2 domain, ``l`` summed from the float32 P,
    P rounded to bf16 before P.V, one rounding of the output to bf16.

    Every tile is taken: for Sq <= Sk each row sees key 0 in the first tile,
    so a tile the kernel skips adds ``exp2(-1e30*log2e - m) = 0`` here.
    ``shift`` moves the causal mask by that many keys and ``rescale=False``
    drops the ``alpha`` rescale of the accumulator: the broken variants that
    the bound must reject.
    """
    hq, hkv, sq, d = q.shape[1], k.shape[1], q.shape[2], q.shape[3]
    k = k.repeat_interleave(hq // hkv, dim=1)
    v = v.repeat_interleave(hq // hkv, dim=1)
    sk = k.shape[2]
    c = (1.0 / d ** 0.5) * LOG2E
    hidden = -1e30 * LOG2E
    rows = torch.arange(sq)[:, None]
    m = torch.full(q.shape[:3] + (1,), hidden)
    l = torch.zeros(q.shape[:3] + (1,))
    acc = torch.zeros(q.shape)
    for k0 in range(0, sk, 128):
        kt, vt = k[:, :, k0:k0 + 128], v[:, :, k0:k0 + 128]
        x = torch.matmul(q, kt.transpose(-1, -2)) * c
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[2])[None, :]
            x = x.masked_fill(cols > rows + (sk - sq) + shift, hidden)
        mx = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - mx)
        p = torch.exp2(x - mx)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = (acc * alpha if rescale else acc) + torch.matmul(p.bfloat16().float(), vt)
        m = mx
    return (acc / l.clamp_min(1e-30)).bfloat16().float()


def _bf16_inputs(rng, b, hq, hkv, sq, sk, d):
    return [torch.from_numpy(a).bfloat16().float() for a in _qkv(rng, b, hq, hkv, sq, sk, d)]


def _share_of_bound(got, q, k, v, causal):
    """Largest |got - want32| / (2^-8 |want32| + (2^-8 + 2^-15) A + 1e-5), with
    want32 the JAX float32 oracle and A the oracle's softmax-weighted mean
    of |v| on the same bf16-valued inputs."""
    from repro.kernels.flash_attention import attention_ref as jref

    rep = q.shape[1] // k.shape[1]
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k.repeat_interleave(rep, 1),
                                                    v.repeat_interleave(rep, 1)))
    want = np.asarray(jref(jq, jk, jv, causal=causal))
    a = np.asarray(jref(jq, jk, jnp.abs(jv), causal=causal))
    tol = 2.0 ** -8 * np.abs(want) + (2.0 ** -8 + 2.0 ** -15) * a + 1e-5
    return float(np.max(np.abs(got.numpy() - want) / tol))


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", [
    (1, 2, 2, 128, 128, 64, True),
    (1, 4, 2, 1024, 1024, 128, True),   # GQA, eight key tiles
    (1, 2, 2, 1000, 1024, 128, True),   # ragged q
    (1, 2, 2, 256, 256, 64, False),
    (1, 8, 2, 256, 384, 32, True),      # decode-aligned rectangular
])
def test_sm90_rounding_within_derived_bound(rng, b, hq, hkv, sq, sk, d, causal):
    """Rounding P to bf16 costs each term of P.V a relative error of at most
    u = 2^-8, so the sum moves by at most u * A; the output's own rounding
    adds u * |want32|, and 2^-15 * A covers the second-order terms. An
    emulation of the kernel's rounding lies within that bound of the JAX
    float32 oracle: the bound that ``tests/test_torch_cuda.py`` and
    ``chip_smoke.py`` hold the kernel to."""
    q, k, v = _bf16_inputs(rng, b, hq, hkv, sq, sk, d)
    assert _share_of_bound(_emulate_sm90(q, k, v, causal), q, k, v, causal) <= 1.0


@pytest.mark.parametrize("fault", ["mask_shifted_by_one_key", "alpha_dropped"])
def test_sm90_bound_rejects_broken_variants(rng, fault):
    """The bound is not vacuous: a kernel whose causal mask lets one more key
    through, or that forgets to rescale its accumulator, breaks it."""
    q, k, v = _bf16_inputs(rng, 1, 4, 2, 1024, 1024, 128)
    kw = {"shift": 1} if fault == "mask_shifted_by_one_key" else {"rescale": False}
    assert _share_of_bound(_emulate_sm90(q, k, v, True, **kw), q, k, v, True) > 1.0


# ------------------------------------ the float32 kernel's split-TF32 model
def _tf32(x):
    """``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, ties away
    from zero (the low 13 bits cleared after adding half of them)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_product(a, b, passes):
    """``a @ b`` as the tensor cores form it from TF32 operands: with
    ``passes=3`` each operand is split into hi = tf32(x) and lo = tf32(x -
    hi) and the product is lo.hi' + hi.lo' + hi.hi', small terms first
    (lo.lo' is dropped); ``passes=2`` drops hi.lo' too, and ``passes=1`` is
    plain TF32, hi.hi' alone."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    small = _tf32(a - ah) @ bh
    if passes == 3:
        small = small + ah @ _tf32(b - bh)
    return small + ah @ bh


def _emulate_split_tf32(q, k, v, causal=True, passes=3):
    """The arithmetic of ``csrc/flash_attention.cu`` in plain torch on
    float32 tensors: 128-row query tiles laid out as the reference's
    front-padded blocks (the first starts at row -((-Sq) mod 128)), each
    running 64-key tiles up to its causal limit (a tile wholly above the
    diagonal runs none and writes 0); S = Q.K^T and O += P.V as split-TF32
    products; logits scaled, then masked to -1e30; the online softmax in
    float32 with exp; the output acc / max(l, 1e-30)."""
    hq, hkv, sq, d = q.shape[1], k.shape[1], q.shape[2], q.shape[3]
    k = k.repeat_interleave(hq // hkv, dim=1)
    v = v.repeat_interleave(hq // hkv, dim=1)
    sk = k.shape[2]
    scale, off, pad = 1.0 / d ** 0.5, sk - sq, (-sq) % 128
    qp = torch.nn.functional.pad(q, (0, 0, pad, 0))
    out = torch.empty(q.shape)
    for t0 in range(0, sq + pad, 128):
        row0 = t0 - pad
        n = -(-sk // 64)
        if causal:
            lim = row0 + 127 + off
            n = 0 if lim < 0 else min(n, lim // 64 + 1)
        qt = qp[:, :, t0:t0 + 128]
        rows = torch.arange(row0, row0 + 128)[:, None]
        m = torch.full(qt.shape[:3] + (1,), -1e30)
        l = torch.zeros(qt.shape[:3] + (1,))
        acc = torch.zeros(qt.shape)
        for k0 in range(0, 64 * n, 64):
            kt, vt = k[:, :, k0:k0 + 64], v[:, :, k0:k0 + 64]
            x = _split_product(qt, kt.transpose(-1, -2), passes) * scale
            if causal:
                cols = torch.arange(k0, k0 + kt.shape[2])[None, :]
                x = x.masked_fill(cols > rows + off, -1e30)
            mx = torch.maximum(m, x.amax(-1, keepdim=True))
            alpha = torch.exp(m - mx)
            p = torch.exp(x - mx)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + _split_product(p, vt, passes)
            m = mx
        out[:, :, max(row0, 0):row0 + 128] = (acc / l.clamp_min(1e-30))[:, :, max(-row0, 0):]
    return out


def _f32_err(got, q, k, v, causal, rows=slice(None)):
    """Largest |got - want| over ``rows``, want the JAX float32 oracle."""
    from repro.kernels.flash_attention import attention_ref as jref

    rep = q.shape[1] // k.shape[1]
    want = np.asarray(jref(*(jnp.asarray(t.numpy()) for t in (
        q, k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1))), causal=causal))
    return float(np.max(np.abs(got.numpy()[:, :, rows] - want[:, :, rows])))


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal",
                         SHAPES + [(1, 4, 2, 1024, 1024, 128, True)])   # GQA, sixteen key tiles
def test_split_tf32_within_reference_tolerance(rng, b, hq, hkv, sq, sk, d, causal):
    """Three TF32 passes carry about 21 bits of each product: an emulation
    of the float32 kernel's rounding lies within the reference's 2e-5 of
    the JAX float32 oracle at the reference's shapes and at a GQA shape of
    sixteen key tiles, the bound ``tests/test_torch_cuda.py`` and
    ``chip_smoke.py`` hold the kernel to."""
    q, k, v = map(torch.from_numpy, _qkv(rng, b, hq, hkv, sq, sk, d))
    assert _f32_err(_emulate_split_tf32(q, k, v, causal), q, k, v, causal) < 2e-5


@pytest.mark.parametrize("passes", [1, 2])
def test_split_tf32_tolerance_needs_the_split(rng, passes):
    """The 2e-5 is not vacuous: plain TF32 (one pass, about 11 bits of each
    operand) breaks it at (1, 4, 2, 1024, 1024, 128), and so does the split
    with one of its two small terms dropped."""
    q, k, v = map(torch.from_numpy, _qkv(rng, 1, 4, 2, 1024, 1024, 128))
    assert _f32_err(_emulate_split_tf32(q, k, v, True, passes=passes), q, k, v, True) > 2e-5


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", [(1, 2, 2, 200, 128, 64), (1, 4, 2, 300, 128, 128)])
def test_split_tf32_rows_without_keys_match_tpu_kernel(rng, b, hq, hkv, sq, sk, d):
    """Causal, Sq > Sk: rows r < Sq - Sk see no key. With Sk % 128 == 0 the
    float32 kernel's query tiles put them all in tiles it skips whole, so
    they come out exactly 0, as through the reference's Pallas kernel
    (interpret mode); the other rows lie within 2e-5 of it."""
    q, k, v = map(torch.from_numpy, _qkv(rng, b, hq, hkv, sq, sk, d))
    got = _emulate_split_tf32(q, k, v, True).numpy()
    want = np.asarray(jattention(*map(jnp.asarray, (q.numpy(), k.numpy(), v.numpy())),
                                 causal=True, use_pallas=True))
    dark = sq - sk
    assert np.all(got[:, :, :dark] == 0) and np.all(want[:, :, :dark] == 0)
    assert float(np.max(np.abs(got[:, :, dark:] - want[:, :, dark:]))) < 2e-5
