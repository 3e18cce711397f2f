"""Train and serve step factories and the host training loop
(``repro/train/train_loop.py``) for one device.

``make_train_step`` returns ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)`` with:

* microbatch gradient accumulation: the batch arrives shaped ``(accum,
  micro_batch, seq)``; each microbatch's gradients are summed in float32
  and the sum divided by ``accum``;
* gradients by ``torch.autograd.grad`` with respect to the parameter leaves
  themselves (the stacked per-layer tensors, so they keep the reference's
  tree);
* the configured optimizer, which updates parameters and optimizer state in
  place (:mod:`repro_torch.train.optimizer`).

The reference's meshes, shardings and buffer donation have no counterpart
here: everything lies on one device (sharding comes with a later slice).
The forward, prefill and serve steps run under ``torch.no_grad()``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .._device import torch_device
from ..configs.base import ModelConfig
from ..models.convert import tree_leaves, tree_map, unflatten_like
from ..models.model import build_model
from .optimizer import OptConfig, opt_init, opt_update


def batch_struct(cfg: ModelConfig, global_batch: int, seq: int, accum: int) -> dict:
    """Shape and dtype of each input of one training batch (microbatched layout)."""
    if global_batch % accum:
        raise ValueError(f"global batch {global_batch} is not a multiple of accum {accum}")
    mb = global_batch // accum
    out = {"tokens": ((accum, mb, seq), torch.int32)}
    if cfg.family == "encdec":
        out["frames"] = ((accum, mb, seq // cfg.frontend_downsample,
                          cfg.frontend_dim or cfg.d_model), torch.float32)
    if cfg.family == "vlm":
        out["tokens"] = ((accum, mb, seq - cfg.vision_tokens), torch.int32)
        out["patches"] = ((accum, mb, cfg.vision_tokens, cfg.frontend_dim), torch.float32)
    return out


def _accum_steps(cfg: ModelConfig, global_batch: int) -> int:
    """The reference's clamp on one device: the largest count up to
    ``cfg.grad_accum`` that divides the batch."""
    accum = max(1, min(cfg.grad_accum, max(global_batch, 1)))
    while global_batch % accum and accum > 1:
        accum -= 1
    return accum


def _on(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v)
            .to(device) for k, v in batch.items()}


def value_and_grad(loss_fn):
    """``jax.value_and_grad(loss_fn, has_aux=True)`` over the port's trees:
    ``(params, batch) -> ((loss, metrics), grads)``, ``grads`` a tree like
    ``params`` with the gradient of each leaf in the leaf's dtype.

    The leaves' storage enters as fresh autograd leaves, so the caller's
    tensors keep ``requires_grad`` off and other uses of them build no graph."""
    def fn(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss, metrics = loss_fn(live, batch)
            grads = torch.autograd.grad(loss, tree_leaves(live))
        metrics = {k: v.detach() if torch.is_tensor(v) else v for k, v in metrics.items()}
        return (loss.detach(), metrics), unflatten_like(params, grads)

    return fn


def make_train_step(cfg: ModelConfig, oc: OptConfig, global_batch: int, seq: int,
                    device="cuda"):
    """Returns (train_step, batch_struct)."""
    dev = torch_device(device)
    grad_fn = value_and_grad(build_model(cfg).loss)
    accum = _accum_steps(cfg, global_batch)
    bstruct = batch_struct(cfg, global_batch, seq, accum)

    def train_step(params, opt_state, batch):
        batch = _on(batch, dev)
        if batch["tokens"].shape[0] != accum:
            raise ValueError(f"batch has {batch['tokens'].shape[0]} microbatches, "
                             f"expected {accum}")
        gsum = None
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        ce_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(accum):
            (_, metrics), grads = grad_fn(params, {k: v[i] for k, v in batch.items()})
            grads = [g.float() for g in tree_leaves(grads)]
            gsum = grads if gsum is None else [a.add_(g) for a, g in zip(gsum, grads)]
            loss_sum += metrics["loss"].float()
            ce_sum += metrics["ce_loss"].float()
            del metrics, grads
        if accum > 1:
            gsum = [g.div_(accum) for g in gsum]
        gtree = unflatten_like(params, gsum)
        params, opt_state, opt_metrics = opt_update(oc, params, gtree, opt_state)
        metrics = {"loss": loss_sum / accum, "ce_loss": ce_sum / accum, **opt_metrics}
        return params, opt_state, metrics

    return train_step, bstruct


def _forward_batch(cfg: ModelConfig, global_batch: int, seq: int) -> dict:
    return {k: (shape[1:], dt) for k, (shape, dt)
            in batch_struct(cfg, global_batch, seq, 1).items()}


def make_forward_step(cfg: ModelConfig, global_batch: int, seq: int, device="cuda"):
    """Inference forward (no backward, no optimizer): ``(params, batch) ->``
    the argmax token at every position. Returns (forward_step, batch_struct)."""
    dev = torch_device(device)
    model = build_model(cfg)

    @torch.no_grad()
    def fwd(params, batch):
        logits, _, _ = model.forward(params, _on(batch, dev))
        return torch.argmax(logits, dim=-1)

    return fwd, _forward_batch(cfg, global_batch, seq)


def make_prefill_step(cfg: ModelConfig, global_batch: int, seq: int, device="cuda"):
    """Prefill into a ``seq``-long cache, returning the next-token argmax:
    ``(params, batch, cache) -> (next_tok (B, 1) int32, cache)``. Returns
    (prefill_step, batch_struct, new_cache), ``new_cache()`` an empty cache."""
    dev = torch_device(device)
    model = build_model(cfg)

    @torch.no_grad()
    def prefill(params, batch, cache):
        logits, new_cache = model.forward_with_cache(params, _on(batch, dev), cache)
        return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32), new_cache

    return (prefill, _forward_batch(cfg, global_batch, seq),
            lambda: model.init_cache(global_batch, seq, device=dev))


def make_serve_step(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """One-token decode: ``(params, tokens (B, 1), cache) -> (next_tok, cache)``,
    the cache written in place. Returns (serve_step, new_cache)."""
    dev = torch_device(device)
    model = build_model(cfg)

    @torch.no_grad()
    def serve_step(params, tokens, cache):
        logits, new_cache = model.decode_step(params, torch.as_tensor(tokens).to(dev), cache)
        return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32), new_cache

    return serve_step, lambda: model.init_cache(batch, max_len, device=dev)


# ------------------------------------------------------------------ host loop
@dataclass
class TrainState:
    params: object
    opt_state: object
    step: int = 0


def run_train_loop(
    cfg: ModelConfig,
    oc: OptConfig,
    data_iter,
    *,
    global_batch: int,
    seq: int,
    steps: int,
    checkpoint_mgr=None,
    checkpoint_every: int = 0,
    log_every: int = 10,
    resume: bool = True,
    rng_seed: int = 0,
    heartbeat=None,
    fail_at_step: int = -1,
    device="cuda",
):
    """The host loop: init-or-resume, step, log, checkpoint.

    ``fail_at_step`` injects a crash (fault-tolerance tests and drills).
    The last checkpoint is written once: where the cadence has just saved
    step ``steps``, the reference's second write of the same state is not
    repeated."""
    dev = torch_device(device)
    step_fn, _ = make_train_step(cfg, oc, global_batch, seq, device=dev)
    model = build_model(cfg)
    start_step = 0
    params = opt_state = None
    if checkpoint_mgr is not None and resume:
        restored = checkpoint_mgr.restore_latest(device=dev)
        if restored is not None:
            start_step, params, opt_state = restored
            print(f"[train] resumed from step {start_step}")
    if params is None:
        params = model.init(rng_seed, device=dev)
        opt_state = opt_init(oc, params, cfg.opt_state_dtype)

    history = []
    saved = None
    t0 = time.time()
    for step in range(start_step, steps):
        if step == fail_at_step:
            raise RuntimeError(f"injected failure at step {step}")
        batch = next(data_iter)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if heartbeat is not None:
            heartbeat(step)
        if log_every and (step % log_every == 0 or step == steps - 1):
            m = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t0
            print(f"[train] step {step} loss={m['loss']:.4f} ce={m['ce_loss']:.4f} "
                  f"lr={m['lr']:.2e} gnorm={m['grad_norm']:.2f} ({dt:.1f}s)")
            history.append({"step": step, **m})
        if checkpoint_mgr is not None and checkpoint_every and (step + 1) % checkpoint_every == 0:
            checkpoint_mgr.save(step + 1, params, opt_state)
            saved = step + 1
    if checkpoint_mgr is not None and checkpoint_every and saved != steps:
        checkpoint_mgr.save(steps, params, opt_state)
    return TrainState(params, opt_state, steps), history
