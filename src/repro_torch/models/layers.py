"""Shared neural-net layers: norms, RoPE, SwiGLU MLP, initializers.

Plain functions over dicts of tensors, as in the reference
(``repro/models/layers.py``): weights keep its ``(d_in, d_out)`` layout and
each use casts them to the activation dtype (``x @ W.to(x.dtype)``).
Random initializers draw from an explicit :class:`torch.Generator`; the
numbers differ from ``jax.random`` for the same seed, so tests that compare
the two packages carry the reference's weights across
(:mod:`repro_torch.models.convert`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..sharding.dtensor import batch_sum, replicate_dim


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# ------------------------------------------------------------------- init
class MetaGenerator:
    """Stands in for a :class:`torch.Generator` where parameters are only
    described (device ``meta``): the initialisers then draw nothing and
    allocate nothing, and give the shapes and dtypes of a real init."""

    device = torch.device("meta")


def dense_init(gen: torch.Generator, shape, in_axis: int = 0, scale: float = 1.0,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init on ``gen``'s device. ``shape`` may carry
    leading stack axes (layers, experts); ``in_axis`` names the fan-in axis.

    The draw is float32, one trailing matrix at a time into an output of
    ``dtype``, so the float32 scratch is one matrix, not the whole stack
    (arctic's bf16 expert stacks would need 36 GB of it each)."""
    std = scale / float(shape[in_axis]) ** 0.5
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    if out.is_meta:
        return out
    for idx in np.ndindex(*shape[:-2]):
        w = torch.empty(shape[-2:], dtype=torch.float32, device=gen.device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        out[idx] = w.mul_(std)
    return out


def embed_init(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return w.normal_(0.0, 1.0, generator=gen).mul_(0.02).to(dtype)


# ------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(dt)


# -------------------------------------------------------------------- RoPE
def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> tuple:
    """positions: any shape -> (cos, sin) with trailing dim head_dim//2."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exps)   # float32, as jnp's weak-typed scalar power
    ang = positions.float()[..., None] * freqs  # (..., half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,) or scalar. Half-split
    rotation (not interleaved), f32 angles, as the reference."""
    d = x.shape[-1]
    cos, sin = rope_angles(positions, d, theta)  # (B, S, half) or (S, half)
    while cos.dim() < x.dim() - 1:  # broadcast to (B, S, 1, half)
        cos, sin = cos[None], sin[None]
    cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_embedding(n_pos: int, dim: int, device="cpu") -> torch.Tensor:
    """Whisper-style fixed sinusoidal positions (encoder frames), built in
    numpy float64 and cast to float32, as the reference builds them."""
    pos = np.arange(n_pos)[:, None]
    i = np.arange(dim // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / dim)
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    return torch.from_numpy(emb.astype(np.float32)).to(device)


# --------------------------------------------------------------------- MLP
def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype, stack=()) -> dict:
    s, ax = tuple(stack), len(stack)
    return {
        "w_gate": dense_init(gen, (*s, d_model, d_ff), ax, dtype=dtype),
        "w_up": dense_init(gen, (*s, d_model, d_ff), ax, dtype=dtype),
        "w_down": dense_init(gen, (*s, d_ff, d_model), ax, dtype=dtype),
    }


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU feed-forward."""
    h = torch.nn.functional.silu(x @ params["w_gate"].to(x.dtype)) \
        * (x @ params["w_up"].to(x.dtype))
    return h @ params["w_down"].to(x.dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, mask=None,
                       impl: str = "gather"):
    """Token-mean cross entropy (float32 accumulation); labels < 0 are
    ignored and the count is clamped to 1. Returns (loss, count).

    ``impl="gather"`` upcasts the logits to float32 and gathers the gold
    logit. ``impl="onehot"`` keeps them in their own dtype: the max is
    subtracted there, and only the exp and its sum run in float32 (the
    reference's one-hot contraction picks the gold logit exactly, as the
    gather does)."""
    # on a mesh the head shards the vocab over 'model' (the reference's
    # lm_head spec) and may leave partial sums over the FSDP axes; the gather
    # of the gold logit has no rule for either, so the logits are made whole
    # along the vocab first (an explicit all-gather over 'model', an
    # all-reduce of partial sums); the batch stays sharded
    logits = replicate_dim(logits, -1)
    valid = (labels >= 0) if mask is None else mask & (labels >= 0)
    safe = labels.clamp(min=0).long()[..., None]
    count = valid.sum().clamp(min=1)
    if impl == "gather":
        logits32 = logits.float()
        logz = torch.logsumexp(logits32, dim=-1)
        gold = torch.gather(logits32, -1, safe)[..., 0]
    else:
        m = logits.amax(dim=-1).detach()   # the reference's stop_gradient
        shifted = logits - m[..., None]
        sumexp = torch.exp(shifted.float()).sum(dim=-1)
        logz = torch.log(sumexp) + m.float()
        gold = torch.gather(logits, -1, safe)[..., 0].float()
    nll = (logz - gold) * valid
    return batch_sum(nll) / count, count
