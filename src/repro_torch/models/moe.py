"""Mixture-of-Experts feed-forward (``repro/models/moe.py``).

Sort-based capacity dispatch, as in the reference:

1. router logits (float32) -> top-k experts and renormalised gates per token;
2. flat (token, expert) assignments are sorted by expert (a stable sort);
   each gets a rank within its expert, and assignments past ``capacity``
   drop;
3. tokens scatter into per-expert buffers ``(G, E, C, d)``; the experts run
   as batched matrix products;
4. outputs gather back, weighted by their gates, and each token sums its k
   contributions.

Supports qwen2-moe (shared experts + routed top-4, experts padded to a
count of 64 with -1e30 router logits) and arctic (a parallel dense FFN
residual + 128 routed top-2). Aux losses: the switch-style load-balance
loss and the router z-loss.

The reference's ``_constrain`` (a sharding hint for its mesh, with no effect
on one device) has no counterpart: the port runs on one card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import dense_init, init_mlp, mlp


def _padded_experts(moe) -> int:
    return max(moe.pad_experts_to, moe.n_experts)


def init_moe(gen, cfg, dtype, stack=()) -> dict:
    moe = cfg.moe
    d, f = cfg.d_model, moe.d_expert
    e = _padded_experts(moe)
    s, ax = tuple(stack), len(stack)
    p = {
        "router": dense_init(gen, (*s, d, e), ax, dtype=torch.float32),  # float32 router
        "w_gate": dense_init(gen, (*s, e, d, f), ax + 1, dtype=dtype),
        "w_up": dense_init(gen, (*s, e, d, f), ax + 1, dtype=dtype),
        "w_down": dense_init(gen, (*s, e, f, d), ax + 1, dtype=dtype),
    }
    if moe.n_shared:
        p["shared"] = init_mlp(gen, d, moe.n_shared * f, dtype, stack=s)
    if moe.dense_ff_parallel:
        p["dense"] = init_mlp(gen, d, moe.dense_ff_parallel, dtype, stack=s)
    return p


def top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, the lowest index
    first among equal values (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(cfg, p, xf):
    """xf: (..., d) -> (probs, gates, expert_idx, logits) with padding masked."""
    moe = cfg.moe
    e_pad = _padded_experts(moe)
    logits = xf.float() @ p["router"].float()
    if e_pad > moe.n_experts:
        pad = torch.arange(e_pad, device=logits.device) >= moe.n_experts
        logits = logits.masked_fill(pad, -1e30)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, moe.top_k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, gate_vals, expert_idx, logits


def _aux_losses(cfg, probs, expert_idx, logits):
    moe = cfg.moe
    e_pad = probs.shape[-1]
    n_assign = expert_idx.numel()
    me = probs.reshape(-1, e_pad).mean(dim=0)
    ce = torch.bincount(expert_idx.reshape(-1), minlength=e_pad).float() / n_assign
    aux_loss = moe.n_experts * torch.sum(me * ce) * moe.aux_loss_weight
    z_loss = moe.router_z_weight * torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return {"moe_aux_loss": aux_loss, "router_z_loss": z_loss}


def _rank_within_expert(sorted_e: torch.Tensor) -> torch.Tensor:
    """Rank of each sorted assignment within its expert run:
    rank = pos - cummax(segment-start positions)."""
    nk = sorted_e.shape[-1]
    pos = torch.arange(nk, device=sorted_e.device).expand_as(sorted_e)
    start = torch.ones_like(sorted_e, dtype=torch.bool)
    start[..., 1:] = sorted_e[..., 1:] != sorted_e[..., :-1]
    seg_start = torch.where(start, pos, torch.zeros_like(pos))
    running = torch.cummax(seg_start, dim=-1).values
    return pos - running


def _dispatch(flat_e: torch.Tensor, capacity: int, e_pad: int):
    """(G, n*k) expert ids -> (order, keep, buf_slot): the stable sort by
    expert, which assignments fit in their expert's capacity, and each
    one's buffer row (the sentinel ``e_pad * capacity`` for a drop)."""
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    rank = _rank_within_expert(sorted_e)
    keep = rank < capacity
    buf_slot = torch.where(keep, sorted_e * capacity + rank,
                           torch.full_like(rank, e_pad * capacity))
    return order, keep, buf_slot


def moe_block(cfg, p, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> (out, aux).

    ``moe_grouped=True`` dispatches within groups of one batch row each;
    ``False`` runs one dispatch over all B*S tokens. Capacity divides by
    the real expert count. Dropped assignments write to a sentinel row
    past the buffer, which is discarded, and contribute nothing.
    """
    moe = cfg.moe
    b, s, d = x.shape
    e_pad = _padded_experts(moe)
    k = moe.top_k
    g, n = (b, s) if cfg.moe_grouped else (1, b * s)
    capacity = max(int(moe.capacity_factor * n * k / moe.n_experts), k)

    xg = x.reshape(g, n, d)
    probs, gate_vals, expert_idx, logits = _router(cfg, p, xg)   # (g,n,·)
    aux = _aux_losses(cfg, probs, expert_idx, logits)

    flat_e = expert_idx.reshape(g, n * k)
    flat_gates = gate_vals.reshape(g, n * k)
    order, keep, buf_slot = _dispatch(flat_e, capacity, e_pad)
    sentinel = e_pad * capacity
    token_of = order // k                                        # (g, n*k)

    gidx = torch.arange(g, device=x.device)[:, None]
    buf = torch.zeros((g, sentinel + 1, d), dtype=x.dtype, device=x.device)
    vals = xg[gidx, token_of]
    buf[gidx, buf_slot] = vals * keep[..., None].to(x.dtype)
    expert_in = buf[:, :-1].reshape(g, e_pad, capacity, d)

    # ---- expert computation: batched products over the expert axis
    h = F.silu(torch.einsum("gecd,edf->gecf", expert_in, p["w_gate"].to(x.dtype))) \
        * torch.einsum("gecd,edf->gecf", expert_in, p["w_up"].to(x.dtype))
    expert_out = torch.einsum("gecf,efd->gecd", h, p["w_down"].to(x.dtype))

    # ---- combine: each assignment's gated output, put back in (token, k)
    # order through the inverse of ``order`` and summed over k (no atomics,
    # so the card gives the same sums on every run)
    out_flat = expert_out.reshape(g, sentinel, d)
    contrib = out_flat[gidx, buf_slot.clamp(max=sentinel - 1)]
    sorted_gates = torch.gather(flat_gates, 1, order)
    contrib = contrib * (sorted_gates * keep)[..., None].to(x.dtype)
    unsorted = torch.empty_like(contrib)
    unsorted[gidx, order] = contrib
    y = unsorted.reshape(b * s, k, d).sum(dim=1)

    xf = x.reshape(b * s, d)
    if moe.n_shared:
        y = y + mlp(p["shared"], xf)
    if moe.dense_ff_parallel:
        y = y + mlp(p["dense"], xf)
    return y.reshape(b, s, d), aux
