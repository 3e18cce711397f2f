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

Every factory takes ``mesh=None``. Without a mesh everything lies on one
device as plain tensors. With a ``torch.distributed`` device mesh
(:mod:`repro_torch.launch.mesh`) the step takes the reference's partition
rules (:mod:`repro_torch.sharding.specs`): parameters, optimizer state
(leaf for leaf, Adafactor's factors following their parameter's spec
minus the reduced dim), batches (on the batch axes) and caches (on
``cache_specs``) are DTensors, and the model runs on them with each op's
sharding propagated (:func:`mesh_layout`, :func:`place`). Every rank holds
the same global batch and keeps its own block. Gradient accumulation is
clamped so that each microbatch tiles the batch axes. Buffer donation has
no counterpart: the optimizer updates in place. The forward, prefill and
serve steps run under ``torch.no_grad()`` and return tokens as plain
tensors, whole on every rank.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import numpy as np
import torch

from .._device import torch_device
from ..configs.base import ModelConfig
from ..models.convert import tree_leaves, tree_map, unflatten_like
from ..models.model import build_model
from ..sharding.dtensor import axes_placements, full, mesh_scope, replicate_dim, shard_tensor
from ..sharding.specs import (P, batch_axes, cache_specs, mesh_axis_sizes, param_specs,
                              to_placements)
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


def _accum_steps(cfg: ModelConfig, global_batch: int, dp_size: int = 1) -> int:
    """The reference's clamp: the largest count up to ``cfg.grad_accum``
    that divides the batch into microbatches that tile the ``dp_size``
    batch shards (1 without a mesh)."""
    accum = max(1, min(cfg.grad_accum, max(global_batch // max(dp_size, 1), 1)))
    while global_batch % accum or (global_batch // accum) % dp_size:
        accum -= 1
        if accum == 1:
            break
    return accum


# ---------------------------------------------------------------- the mesh
@dataclass(frozen=True)
class MeshLayout:
    """Where every leaf lies on a mesh: DTensor placements (one tuple a
    leaf) of the parameters and the optimizer state, and the partition
    rules' fallback notes."""

    mesh: object
    params: dict
    opt_state: dict | None
    fallbacks: list


def opt_specs(oc: OptConfig, pspecs: dict, pshape: dict) -> dict:
    """The optimizer state's specs: AdamW's moments mirror their parameter;
    Adafactor's row and column factors take its spec minus the reduced dim
    (the reference's ``build_opt_shardings``)."""
    if oc.kind == "adamw":
        return {"m": pspecs, "v": pspecs, "step": P()}

    def fspec(spec, leaf):
        if len(leaf.shape) >= 2:
            return {"vr": P(*spec[:-1]), "vc": P(*spec[:-2], spec[-1])}
        return {"v": P(*spec)}

    return {"f": tree_map(fspec, pspecs, pshape), "step": P()}


def mesh_layout(cfg: ModelConfig, mesh, oc: OptConfig | None = None) -> MeshLayout:
    """The placements of ``cfg``'s parameters (and of ``oc``'s state) on
    ``mesh``, from shapes alone (a ``meta`` init, no allocation)."""
    pshape = build_model(cfg).init(0, device="meta")
    pspecs, fallbacks = param_specs(cfg, mesh, pshape)
    opl = None if oc is None else to_placements(mesh, opt_specs(oc, pspecs, pshape))
    return MeshLayout(mesh, to_placements(mesh, pspecs), opl, fallbacks)


def place(tree, mesh, placements):
    """Each leaf of ``tree`` (the same global value on every rank) as a
    DTensor with its placements; a leaf's values do not change."""
    return tree_map(lambda t, pl: shard_tensor(t, mesh, pl), tree, placements)


def _dp_size(mesh) -> int:
    sizes = mesh_axis_sizes(mesh)
    n = 1
    for a in batch_axes(mesh) or ():
        n *= sizes[a]
    return n


def _place_batch(batch: dict, mesh, lead: int) -> dict:
    """Batch leaves sharded on the batch axes at dim ``lead`` (after the
    microbatch dim, if any), whole where the size does not divide."""
    dp = batch_axes(mesh)
    return {k: shard_tensor(v, mesh, axes_placements(mesh, v.shape, (None,) * lead + (dp,)))
            for k, v in batch.items()}


def _mesh_scope(mesh):
    """:func:`repro_torch.sharding.dtensor.mesh_scope` with a mesh; nothing
    without one."""
    return contextlib.nullcontext() if mesh is None else mesh_scope()


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
                    device="cuda", mesh=None):
    """Returns (train_step, batch_struct). With a mesh, ``train_step`` takes
    and returns parameters and optimizer state placed by
    :func:`mesh_layout` and :func:`place`, and a global batch."""
    dev = torch_device(device)
    grad_fn = value_and_grad(build_model(cfg).loss)
    accum = _accum_steps(cfg, global_batch, 1 if mesh is None else _dp_size(mesh))
    bstruct = batch_struct(cfg, global_batch, seq, accum)

    def train_step(params, opt_state, batch):
        batch = _on(batch, dev)
        if batch["tokens"].shape[0] != accum:
            raise ValueError(f"batch has {batch['tokens'].shape[0]} microbatches, "
                             f"expected {accum}")
        if mesh is not None:
            batch = _place_batch(batch, mesh, 1)
        with _mesh_scope(mesh):
            gsum = None
            loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            ce_sum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(accum):
                (_, metrics), grads = grad_fn(params, {k: v[i] for k, v in batch.items()})
                grads = [g.float() for g in tree_leaves(grads)]
                if mesh is not None:
                    # pending partial sums reduce here, in float32
                    grads = [g.redistribute(p.device_mesh, p.placements)
                             for g, p in zip(grads, tree_leaves(params))]
                gsum = grads if gsum is None else [a.add_(g) for a, g in zip(gsum, grads)]
                loss_sum += full(metrics["loss"]).float()
                ce_sum += full(metrics["ce_loss"]).float()
                del metrics, grads
            if accum > 1:
                gsum = [g.div_(accum) for g in gsum]
            gtree = unflatten_like(params, gsum)
            params, opt_state, opt_metrics = opt_update(oc, params, gtree, opt_state)
        metrics = {"loss": loss_sum / accum, "ce_loss": ce_sum / accum,
                   **{k: full(v) for k, v in opt_metrics.items()}}
        return params, opt_state, metrics

    return train_step, bstruct


def _forward_batch(cfg: ModelConfig, global_batch: int, seq: int) -> dict:
    return {k: (shape[1:], dt) for k, (shape, dt)
            in batch_struct(cfg, global_batch, seq, 1).items()}


def _next_token(logits) -> torch.Tensor:
    """The argmax of the last position, (B, 1) int32. On a mesh the vocab
    is gathered whole first (an explicit all-gather over 'model': DTensor's
    argmax over a sharded dim reads values on the host)."""
    return torch.argmax(replicate_dim(logits[:, -1:], -1), dim=-1).to(torch.int32)


def _cache_placements(cfg, mesh, cache):
    specs, _ = cache_specs(cfg, mesh, cache)
    return to_placements(mesh, specs)


def make_forward_step(cfg: ModelConfig, global_batch: int, seq: int, device="cuda", mesh=None):
    """Inference forward (no backward, no optimizer): ``(params, batch) ->``
    the argmax token at every position. Returns (forward_step, batch_struct)."""
    dev = torch_device(device)
    model = build_model(cfg)

    @torch.no_grad()
    def fwd(params, batch):
        batch = _on(batch, dev)
        if mesh is not None:
            batch = _place_batch(batch, mesh, 0)
        with _mesh_scope(mesh):
            logits, _, _ = model.forward(params, batch)
            return full(torch.argmax(replicate_dim(logits, -1), dim=-1))

    return fwd, _forward_batch(cfg, global_batch, seq)


def make_prefill_step(cfg: ModelConfig, global_batch: int, seq: int, device="cuda", mesh=None):
    """Prefill into a ``seq``-long cache, returning the next-token argmax:
    ``(params, batch, cache) -> (next_tok (B, 1) int32, cache)``. Returns
    (prefill_step, batch_struct, new_cache), ``new_cache()`` an empty cache
    (placed on ``cache_specs`` with a mesh)."""
    dev = torch_device(device)
    model = build_model(cfg)

    @torch.no_grad()
    def prefill(params, batch, cache):
        batch = _on(batch, dev)
        if mesh is not None:
            batch = _place_batch(batch, mesh, 0)
        with _mesh_scope(mesh):
            logits, new_cache = model.forward_with_cache(params, batch, cache)
            return full(_next_token(logits)), new_cache

    return (prefill, _forward_batch(cfg, global_batch, seq),
            lambda: _new_cache(model, cfg, global_batch, seq, dev, mesh))


def _new_cache(model, cfg, batch: int, max_len: int, dev, mesh):
    cache = model.init_cache(batch, max_len, device=dev)
    return cache if mesh is None else place(cache, mesh, _cache_placements(cfg, mesh, cache))


def make_serve_step(cfg: ModelConfig, batch: int, max_len: int, device="cuda", mesh=None):
    """One-token decode: ``(params, tokens (B, 1), cache) -> (next_tok, cache)``,
    the cache written in place. Returns (serve_step, new_cache)."""
    dev = torch_device(device)
    model = build_model(cfg)

    @torch.no_grad()
    def serve_step(params, tokens, cache):
        tokens = torch.as_tensor(tokens).to(dev)
        if mesh is not None:
            tokens = _place_batch({"t": tokens}, mesh, 0)["t"]
        with _mesh_scope(mesh):
            logits, new_cache = model.decode_step(params, tokens, cache)
            return full(_next_token(logits)), new_cache

    return serve_step, lambda: _new_cache(model, cfg, batch, max_len, dev, mesh)


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
    mesh=None,
):
    """The host loop: init-or-resume, step, log, checkpoint.

    ``fail_at_step`` injects a crash (fault-tolerance tests and drills).
    The last checkpoint is written once: where the cadence has just saved
    step ``steps``, the reference's second write of the same state is not
    repeated. With a mesh, parameters are initialised whole from the seed
    (the one-device values) and then sharded; a restore places the
    checkpoint's leaves on this mesh, whatever mesh saved them."""
    dev = torch_device(device)
    step_fn, _ = make_train_step(cfg, oc, global_batch, seq, device=dev, mesh=mesh)
    model = build_model(cfg)
    layout = None if mesh is None else mesh_layout(cfg, mesh, oc)
    start_step = 0
    params = opt_state = None
    if checkpoint_mgr is not None and resume:
        restored = checkpoint_mgr.restore_latest(
            device=dev, mesh=mesh,
            placements=None if layout is None else {"params": layout.params,
                                                    "opt_state": layout.opt_state})
        if restored is not None:
            start_step, params, opt_state = restored
            if mesh is None or mesh.get_rank() == 0:
                print(f"[train] resumed from step {start_step}")
    if params is None:
        params = model.init(rng_seed, device=dev)
        opt_state = opt_init(oc, params, cfg.opt_state_dtype)
        if layout is not None:
            params = place(params, mesh, layout.params)
            opt_state = place(opt_state, mesh, layout.opt_state)

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
