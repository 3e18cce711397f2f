"""Mamba2 (SSD, state-space duality) block (``repro/models/ssm.py``).

Chunked SSD forward: within chunks of Q tokens the recurrence is evaluated
as a masked quadratic form (attention-like einsums); across chunks a Python
loop carries the (B, H, N, P) state, where the reference runs a
``lax.scan``. Decode is the plain O(1) recurrence against a persistent
state and convolution ring buffers. All state math runs in float32.

As in the rest of the port's LM stack, a given cache is written in place
(the reference returns new arrays) and returned as the new cache.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..sharding.dtensor import BATCH_AXES, local_call, split_ready
from .layers import dense_init, dtype_of, rms_norm


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no linear cut-over
    (``F.softplus`` returns ``x`` above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssm_dims(cfg) -> tuple[int, int, int, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.headdim
    return d_inner, n_heads, s.d_state, s.conv_width


def init_ssm(gen, cfg, dtype, stack=()) -> dict:
    """One Mamba2 block's parameters (with leading ``stack`` axes).

    ``dt_bias`` and ``A_log`` come from the reference's fixed numpy draws
    (``RandomState(0)`` and ``RandomState(1)``), the same in every layer
    whatever the seed. ``dt_bias`` and ``D`` equal the reference's leaves
    bit for bit. ``A_log`` is the correctly rounded float32 log of the same
    float32 draws; XLA's float32 log is not correctly rounded, so about one
    leaf value in ten lies one ulp from the reference's."""
    d = cfg.d_model
    d_inner, h, n, w = ssm_dims(cfg)
    s, ax = tuple(stack), len(stack)
    dev = gen.device
    dt = np.exp(np.random.RandomState(0).uniform(np.log(1e-3), np.log(1e-1), h))
    dt_bias = dt + np.log(-np.expm1(-dt))   # softplus(dt_bias) in [1e-3, 1e-1]
    a = np.random.RandomState(1).uniform(1, 16, h).astype(np.float32)
    a_log = np.log(a.astype(np.float64))

    def fixed(v: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(dev).expand(*s, h).clone()

    return {
        "wz": dense_init(gen, (*s, d, d_inner), ax, dtype=dtype),
        "wx": dense_init(gen, (*s, d, d_inner), ax, dtype=dtype),
        "wB": dense_init(gen, (*s, d, n), ax, dtype=dtype),
        "wC": dense_init(gen, (*s, d, n), ax, dtype=dtype),
        "wdt": dense_init(gen, (*s, d, h), ax, dtype=dtype),
        "dt_bias": fixed(dt_bias),
        "A_log": fixed(a_log),
        "D": torch.ones((*s, h), dtype=torch.float32, device=dev),
        "conv_x": dense_init(gen, (*s, w, d_inner), ax, dtype=dtype),
        "conv_B": dense_init(gen, (*s, w, n), ax, dtype=dtype),
        "conv_C": dense_init(gen, (*s, w, n), ax, dtype=dtype),
        "norm": torch.ones((*s, d_inner), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, (*s, d_inner, d), ax, dtype=dtype),
    }


def _causal_depthwise_conv(x: torch.Tensor, kernel: torch.Tensor, tail=None):
    """x: (B, L, C), kernel: (w, C). ``tail``: (B, w-1, C) carry-in (decode /
    prefill continuation); defaults to zeros."""
    w = kernel.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], w - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    k = kernel.to(x.dtype)
    y = xp[:, 0:x.shape[1]] * k[0]
    for i in range(1, w):
        y = y + xp[:, i:i + x.shape[1]] * k[i]
    return y


def ssd_scan(xh, dt, a_neg, b_mat, c_mat, chunk: int, init_state=None,
             matmul_dtype=torch.float32):
    """Chunked SSD. xh: (B,L,H,P) f32; dt: (B,L,H) f32; a_neg: (H,) negative;
    b_mat/c_mat: (B,L,N) f32. Returns (y (B,L,H,P), final_state (B,H,N,P)).

    ``matmul_dtype`` rounds the operands of the two intra-chunk products
    (bf16 for mamba2-130m and zamba2); the products are then taken in
    float32, as the reference's ``preferred_element_type=float32`` does.
    A product of two bf16 values is exact in float32, so TF32 on or off
    changes nothing there. The decay, cumsum and state path stays float32.
    ``L`` must be a multiple of ``chunk`` (``ValueError``; the reference
    asserts)."""
    bsz, L, h, p = xh.shape
    n = b_mat.shape[-1]
    if L % chunk:
        raise ValueError(f"sequence length {L} is not a multiple of the chunk {chunk}")
    nc = L // chunk

    def rnd(t):
        return t if matmul_dtype == torch.float32 else t.to(matmul_dtype).float()

    xc = xh.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    bc = b_mat.reshape(bsz, nc, chunk, n)
    cc = c_mat.reshape(bsz, nc, chunk, n)
    da = dtc * a_neg  # (B,nc,Q,H), negative
    cs = torch.cumsum(da, dim=2)
    # intra-chunk quadratic form. The mask goes on BEFORE the exp: the upper
    # triangle's diff = cs_i - cs_j > 0 grows with the chunk and would
    # overflow to inf, and inf * 0 is NaN
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]       # (B,nc,i,j,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device))
    lmat = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                                 torch.tensor(-1e30, device=xh.device)))
    scores = torch.einsum("bcin,bcjn->bcij", rnd(cc), rnd(bc))  # shared across H
    m = rnd(scores[..., None] * lmat * dtc[:, :, None, :, :])
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", m, rnd(xc))
    # per-chunk end states
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)          # (B,nc,Q,H)
    s_chunk = torch.einsum("bcjh,bcjn,bcjhp->bchnp", decay_to_end * dtc, bc, xc)
    chunk_decay = torch.exp(cs[:, :, -1, :])                 # (B,nc,H)
    # inter-chunk state scan
    s = (torch.zeros((bsz, h, n, p), dtype=torch.float32, device=xh.device)
         if init_state is None else init_state.float())
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    s_prev = torch.stack(s_prevs, dim=1)                     # (B,nc,H,N,P)
    y_inter = torch.einsum("bcin,bchnp->bcihp", cc, s_prev) * torch.exp(cs)[..., None]
    y = (y_intra + y_inter).reshape(bsz, L, h, p)
    return y, s


def ssm_forward(cfg, p, x, *, cache=None):
    """Full-sequence Mamba2 block. If ``cache`` is given (prefill), it is
    the carry-in (state and conv tails), and the final state and the new
    conv tails are written into it. Returns (out, cache)."""
    s = cfg.ssm
    d_inner, h, n, w = ssm_dims(cfg)
    bsz, L, _ = x.shape
    z = x @ p["wz"].to(x.dtype)
    xs = x @ p["wx"].to(x.dtype)
    bm = x @ p["wB"].to(x.dtype)
    cm = x @ p["wC"].to(x.dtype)
    dt_raw = x @ p["wdt"].to(x.dtype)
    tails = cache or {}
    xs_c = F.silu(_causal_depthwise_conv(xs, p["conv_x"], tails.get("conv_x")))
    bm_c = F.silu(_causal_depthwise_conv(bm, p["conv_B"], tails.get("conv_B")))
    cm_c = F.silu(_causal_depthwise_conv(cm, p["conv_C"], tails.get("conv_C")))
    dt = softplus(dt_raw.float() + p["dt_bias"])
    a_neg = -torch.exp(p["A_log"])
    xh = split_ready(xs_c.float(), -1, h).reshape(bsz, L, h, s.headdim)
    # each head's scan is its own: on a mesh it runs on each rank's heads
    # and batch rows (local_call), with B and C whole
    scan = functools.partial(ssd_scan, chunk=min(s.chunk, L),
                             matmul_dtype=dtype_of(getattr(cfg, "ssd_matmul_dtype", "float32")))
    heads = (BATCH_AXES, None, "model", None)
    state = (BATCH_AXES, "model", None, None)
    y, s_final = local_call(
        lambda *a: scan(*a[:5], init_state=a[5]),
        (xh, dt, a_neg, bm_c.float(), cm_c.float(), tails.get("state")),
        (heads, heads[:3], ("model",), (BATCH_AXES, None, None), (BATCH_AXES, None, None), state),
        [heads, state], [tuple(xh.shape), (bsz, h, n, s.headdim)])
    y = y + p["D"][None, None, :, None] * xh
    y = y.reshape(bsz, L, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    if cache is not None:
        cache["state"].copy_(s_final)
        cache["conv_x"].copy_(xs[:, -(w - 1):])
        cache["conv_B"].copy_(bm[:, -(w - 1):])
        cache["conv_C"].copy_(cm[:, -(w - 1):])
    return out, cache


def ssm_decode_step(cfg, p, x, cache):
    """One-token decode. x: (B, 1, d); ``cache`` holds the state and the
    conv ring buffers, advanced in place. Returns (out (B,1,d), cache)."""
    s = cfg.ssm
    d_inner, h, n, w = ssm_dims(cfg)
    bsz = x.shape[0]
    xt = x[:, 0]
    z = xt @ p["wz"].to(x.dtype)
    xs = xt @ p["wx"].to(x.dtype)
    bm = xt @ p["wB"].to(x.dtype)
    cm = xt @ p["wC"].to(x.dtype)
    dt_raw = xt @ p["wdt"].to(x.dtype)

    def conv_step(buf, new, kernel):
        full = torch.cat([buf.to(new.dtype), new[:, None]], dim=1)  # (B, w, C)
        out = torch.einsum("bwc,wc->bc", full, kernel.to(new.dtype))
        buf.copy_(full[:, 1:])
        return F.silu(out)

    xs_c = conv_step(cache["conv_x"], xs, p["conv_x"])
    bm_c = conv_step(cache["conv_B"], bm, p["conv_B"])
    cm_c = conv_step(cache["conv_C"], cm, p["conv_C"])
    dt = softplus(dt_raw.float() + p["dt_bias"])                      # (B,H)
    a_neg = -torch.exp(p["A_log"])
    decay = torch.exp(dt * a_neg)                                     # (B,H)
    xh = split_ready(xs_c.float(), -1, h).reshape(bsz, h, s.headdim)
    state = cache["state"].float() * decay[:, :, None, None] + torch.einsum(
        "bh,bn,bhp->bhnp", dt, bm_c.float(), xh)
    cache["state"].copy_(state)
    y = torch.einsum("bn,bhnp->bhp", cm_c.float(), state)
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(bsz, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = (y @ p["out_proj"].to(x.dtype))[:, None]
    return out, cache


def init_ssm_cache(cfg, batch: int, dtype, device) -> dict:
    s = cfg.ssm
    d_inner, h, n, w = ssm_dims(cfg)
    return {
        "state": torch.zeros((batch, h, n, s.headdim), dtype=torch.float32, device=device),
        "conv_x": torch.zeros((batch, w - 1, d_inner), dtype=dtype, device=device),
        "conv_B": torch.zeros((batch, w - 1, n), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, w - 1, n), dtype=dtype, device=device),
    }
