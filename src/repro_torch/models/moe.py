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

On a mesh the dispatch, the experts and the combine each run on every
rank's own blocks (:func:`repro_torch.sharding.dtensor.local_call`), and
the reference's ``_constrain`` hints (``moe_grouped`` only) become the
placements the expert buffers are redistributed to between them; without a
mesh nothing changes.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..sharding.dtensor import BATCH_AXES, is_dtensor, local_call
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


def _expert_counts(flat_idx: torch.Tensor, e_pad: int) -> torch.Tensor:
    """Assignments per expert. ``bincount`` has no sharding rule and its
    output length depends on the data, so on a mesh (and in the dry run's
    fake tensors) the same integer counts come from a compare against each
    expert id and a sum."""
    if is_dtensor(flat_idx):
        ids = torch.arange(e_pad, device=flat_idx.device)
        return (flat_idx[:, None] == ids).sum(dim=0)
    return torch.bincount(flat_idx, minlength=e_pad)


def _aux_losses(cfg, probs, expert_idx, logits):
    moe = cfg.moe
    e_pad = probs.shape[-1]
    n_assign = expert_idx.numel()
    me = probs.reshape(-1, e_pad).mean(dim=0)
    ce = _expert_counts(expert_idx.reshape(-1), e_pad).float() / n_assign
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


def _fill_buffers(sentinel: int, xg, token_of, buf_slot, keep):
    """The per-expert buffers' rows ``(g, E * C, d)``: each kept assignment's
    token at its slot; drops write to the sentinel row past the end, which
    is cut off."""
    g, _, d = xg.shape
    gidx = torch.arange(g, device=xg.device)[:, None]
    buf = torch.zeros((g, sentinel + 1, d), dtype=xg.dtype, device=xg.device)
    vals = xg[gidx, token_of]
    buf[gidx, buf_slot] = vals * keep[..., None].to(xg.dtype)
    return buf[:, :-1]


def _gather_outputs(sentinel: int, out_flat, buf_slot, order, flat_gates, keep):
    """Each assignment's gated expert output, put back in (token, k) order
    through the inverse of ``order`` (no atomics, so the card gives the
    same sums on every run): ``(g, n * k, d)``."""
    g = out_flat.shape[0]
    gidx = torch.arange(g, device=out_flat.device)[:, None]
    contrib = out_flat[gidx, buf_slot.clamp(max=sentinel - 1)]
    sorted_gates = torch.gather(flat_gates, 1, order)
    contrib = contrib * (sorted_gates * keep)[..., None].to(out_flat.dtype)
    unsorted = torch.empty_like(contrib)
    unsorted[gidx, order] = contrib
    return unsorted


def _experts(expert_in, w_gate, w_up, w_down):
    """SwiGLU of every expert over its buffer: (g, E, C, d) -> (g, E, C, d).
    Each weight is cast to the activation dtype just for its product, so
    one cast copy at a time is alive (arctic's bf16 expert stacks are 17 GB
    a layer in float32)."""
    dt = expert_in.dtype
    h = F.silu(torch.einsum("gecd,edf->gecf", expert_in, w_gate.to(dt))) \
        * torch.einsum("gecd,edf->gecf", expert_in, w_up.to(dt))
    return torch.einsum("gecf,efd->gecd", h, w_down.to(dt))


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
    token_of = order // k                                        # (g, n*k)

    sentinel = e_pad * capacity
    # On a mesh each stage runs on every rank's own blocks (local_call): the
    # dispatch and the combine within the groups on the batch axes, the
    # experts with groups on 'data' and experts on 'model' (the reference's
    # ``_constrain`` hints, moe_grouped only), their weights gathered whole
    # but for the expert dim. Between the stages the buffers are
    # redistributed explicitly. Without a mesh these are plain calls.
    grp = BATCH_AXES if cfg.moe_grouped else None
    buf = local_call(functools.partial(_fill_buffers, sentinel),
                     (xg, token_of, buf_slot, keep),
                     ((grp, None, None), (grp, None), (grp, None), (grp, None)),
                     (grp, None, None), (g, sentinel, d))
    expert_in = buf.reshape(g, e_pad, capacity, d)

    # ---- expert computation: batched products over the expert axis
    ep = ("data" if cfg.moe_grouped else None, "model", None, None)
    expert_out = local_call(_experts, (expert_in, p["w_gate"], p["w_up"], p["w_down"]),
                            (ep, *[("model", None, None)] * 3), ep, tuple(expert_in.shape))

    # ---- combine: each assignment's gated output, summed over its token's k
    out_flat = expert_out.reshape(g, sentinel, d)
    unsorted = local_call(functools.partial(_gather_outputs, sentinel),
                          (out_flat, buf_slot, order, flat_gates, keep),
                          ((grp, None, None), (grp, None), (grp, None), (grp, None), (grp, None)),
                          (grp, None, None), (g, n * k, d))
    y = unsorted.reshape(b * s, k, d).sum(dim=1)

    xf = x.reshape(b * s, d)
    if moe.n_shared:
        y = y + mlp(p["shared"], xf)
    if moe.dense_ff_parallel:
        y = y + mlp(p["dense"], xf)
    return y.reshape(b, s, d), aux
