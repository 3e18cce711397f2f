"""User-facing attention op: GQA and the error contract of the reference's
``attention(use_pallas=True)`` (``repro/kernels/flash_attention/ops.py``).

Dispatch follows the tensor's device: a CUDA tensor launches the kernel of
:mod:`.kernel` (or raises), a CPU tensor runs the plain version of
:mod:`.ref`. There is no flag and no fallback between them. Both read kv
head ``h // (Hq/Hkv)`` for query head ``h`` (``jnp.repeat``'s order); the
kernel indexes it instead of materialising the repeat.

The reference front-pads queries to a multiple of its block and slices the
pad off again. Both versions here apply the diagonal ``c <= r + (Sk - Sq)``
row by row and take any ``Sq``, so that pad would change no real row and
is not made; only the reference's error contract on its block is kept.
"""

from __future__ import annotations

import torch

from . import kernel, ref

BLOCK = 128  # the reference's default block_q / block_k, read only by the error contract


def _checked(fn, q, k, v, causal, sm_scale):
    hq, sq = q.shape[1], q.shape[2]
    hkv, sk = k.shape[1], k.shape[2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={hkv}")
    if sk % BLOCK:
        raise ValueError(f"flash path needs Sk % {BLOCK} == 0, got {sk}")
    if not causal and sq % BLOCK:
        raise ValueError(f"non-causal flash path needs Sq % {BLOCK} == 0, got {sq}")
    return fn(q, k, v, causal=causal, sm_scale=sm_scale)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              sm_scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D), k/v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D) in q's dtype.

    Forward only, on both devices: the kernel has no backward (nor has the
    reference's, whose ``jax.grad`` fails), so a call that autograd would
    have to differentiate raises ``RuntimeError`` rather than return an
    output with no gradient on the card and one on the CPU."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "the flash attention op has no backward pass; train with "
            "attn_impl='ref' or 'blocked', or call it under torch.no_grad()")
    if q.device.type == "cuda":
        fn = kernel.flash_attention
    elif q.device.type == "cpu":
        fn = ref.attention_ref
    else:
        raise ValueError(f"unsupported device {q.device}")
    return _checked(fn, q, k, v, causal, sm_scale)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: float | None = None) -> torch.Tensor:
    """:func:`attention` with the plain version on any device: what the
    kernel is held against on the card. Differentiable."""
    return _checked(ref.attention_ref, q, k, v, causal, sm_scale)
