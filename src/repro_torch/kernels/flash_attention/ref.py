"""Plain PyTorch version of the flash-attention kernel: softmax attention
with the reference's masking (``repro/kernels/flash_attention/ref.py``).

Logits are taken in float32 (bf16 inputs are exact in float32), masked with
-1e30 on the decode-aligned causal diagonal ``col <= row + (Sk - Sq)``, and
the probabilities are cast to ``v``'s dtype before the product with ``v``.
Runs on any device; the CPU tests use it and ``chip_smoke.py`` holds the
CUDA kernel against it on the card. It is differentiable: where autograd
needs its gradient, the softmax runs out of place.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, sm_scale: float | None = None) -> torch.Tensor:
    """The kernel's contract in plain torch: q (B, Hq, Sq, D), k/v
    (B, Hkv, Sk, D) with query head ``h`` reading kv head ``h // (Hq/Hkv)``
    (``jnp.repeat``'s order) -> (B, Hq, Sq, D) in q's dtype."""
    hq, hkv = q.shape[1], k.shape[1]
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        logits = logits.masked_fill_(~(cols <= rows + (sk - sq)), NEG_INF)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        # the same steps out of place, so autograd keeps what it saved
        p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        p = p / p.sum(dim=-1, keepdim=True)
    else:
        # in place: at long sequences the (Sq, Sk) float32 logits are the peak
        p = logits.sub_(logits.amax(dim=-1, keepdim=True)).exp_()
        p = p.div_(p.sum(dim=-1, keepdim=True))
    return torch.matmul(p.to(v.dtype), v).to(q.dtype)
