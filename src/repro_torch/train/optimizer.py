"""Optimizers: AdamW (dtype-configurable moments) and factored Adafactor
(``repro/train/optimizer.py``).

Plain functions over the port's dict parameter trees. All math runs in
float32 whatever the storage dtype; moments are stored in
``opt_state_dtype`` (float32 or bf16). Weight decay skips rank < 2 leaves
(norm scales, biases). The opt-state tree has the reference's keys and leaf
dtypes, the int32 ``step`` scalar included.

Unlike the reference's pure functions, :func:`opt_update` writes the new
parameters and optimizer state into the given tensors in place (under
``torch.no_grad()``) and returns those same trees: the values are the
reference's, without a second copy of parameters and moments. The clip of
:func:`clip_by_global_norm` is folded into each leaf's update with the same
roundings, so the update makes no clipped copy of the gradient tree.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..models.convert import flatten_with_paths, tree_leaves, tree_map
from ..models.layers import dtype_of


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    kind: str = "adamw"  # adamw | adafactor


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def lr_schedule(oc: OptConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_ratio``, in float32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(oc.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - oc.warmup_steps) / max(oc.total_steps - oc.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return oc.lr * warm * (oc.min_lr_ratio + (1 - oc.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """One clipped gradient leaf in float32, rounded through its own dtype."""
    return (g.float() * scale).to(g.dtype).float()


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


# ------------------------------------------------------------------- AdamW
def adamw_init(params, state_dtype: str = "float32") -> dict:
    sdt = dtype_of(state_dtype)
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    zeros = lambda p: torch.zeros(p.shape, dtype=sdt, device=p.device)
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


@torch.no_grad()
def adamw_update(oc: OptConfig, params, grads, opt_state):
    """One AdamW step, written into ``params`` and ``opt_state`` in place.
    Returns (params, opt_state, {"lr", "grad_norm"})."""
    step_t = opt_state["step"]
    step_t.add_(1)
    lr = lr_schedule(oc, step_t)
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, oc.grad_clip)
    t = step_t.float()
    bc1 = 1 - _f32(oc.b1, t.device) ** t
    bc2 = 1 - _f32(oc.b2, t.device) ** t
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"])):
        gf = _clipped(g, scale)
        mf = m.float() * oc.b1 + gf * (1 - oc.b1)
        vf = v.float() * oc.b2 + gf * gf * (1 - oc.b2)
        update = (mf / bc1) / (torch.sqrt(vf / bc2) + oc.eps)
        if p.dim() >= 2:
            update = update + oc.weight_decay * p.float()
        p.copy_(p.float() - lr * update)
        m.copy_(mf)
        v.copy_(vf)
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}


# --------------------------------------------------------------- Adafactor
def adafactor_init(params, state_dtype: str = "float32") -> dict:
    sdt = dtype_of(state_dtype)
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")

    def zeros_for(p):
        z = lambda shape: torch.zeros(shape, dtype=sdt, device=p.device)
        if p.dim() >= 2:
            return {"vr": z(p.shape[:-1]), "vc": z(p.shape[:-2] + p.shape[-1:])}
        return {"v": z(p.shape)}

    return {"f": tree_map(zeros_for, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adafactor_update(oc: OptConfig, params, grads, opt_state):
    """One factored Adafactor step, in place. Returns (params, opt_state,
    {"lr", "grad_norm"})."""
    step_t = opt_state["step"]
    step_t.add_(1)
    lr = lr_schedule(oc, step_t)
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, oc.grad_clip)
    beta2 = 1.0 - (step_t.float() + 1.0) ** -0.8
    fs = opt_state["f"]
    factors = [f for _, f in flatten_with_paths(fs, upto=params)]
    for p, g, f in zip(tree_leaves(params), tree_leaves(grads), factors):
        gf = _clipped(g, scale)
        g2 = gf * gf + 1e-30
        if p.dim() >= 2:
            vr = f["vr"].float() * beta2 + g2.mean(-1) * (1 - beta2)
            vc = f["vc"].float() * beta2 + g2.mean(-2) * (1 - beta2)
            denom = (vr[..., None] / torch.clamp(vr.mean(-1, keepdim=True)[..., None], min=1e-30)) \
                * vc[..., None, :]
            update = gf / torch.sqrt(torch.clamp(denom, min=1e-30))
            f["vr"].copy_(vr)
            f["vc"].copy_(vc)
        else:
            v = f["v"].float() * beta2 + g2 * (1 - beta2)
            update = gf / torch.sqrt(torch.clamp(v, min=1e-30))
            f["v"].copy_(v)
        # relative-scale clipping (Adafactor's d=1)
        rms = torch.sqrt(torch.mean(update * update) + 1e-30)
        update = update / torch.clamp(rms, min=1.0)
        if p.dim() >= 2:
            update = update + oc.weight_decay * p.float()
        p.copy_(p.float() - lr * update)
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}


def opt_init(oc: OptConfig, params, state_dtype="float32"):
    if oc.kind == "adamw":
        return adamw_init(params, state_dtype)
    return adafactor_init(params, state_dtype)


def opt_update(oc: OptConfig, params, grads, opt_state):
    if oc.kind == "adamw":
        return adamw_update(oc, params, grads, opt_state)
    return adafactor_update(oc, params, grads, opt_state)
