"""Model construction for every family (``repro/models/model.py``).

``build_model(cfg)`` returns a :class:`Model` whose members are plain
functions over dicts of tensors, as in the reference:

* ``init(seed, device="cuda")``: parameters, drawn on ``device`` from a
  seeded :class:`torch.Generator`. Layer weights are stacked with a leading
  ``n_layers`` axis and keep the reference's ``(d_in, d_out)`` layout, so
  :func:`repro_torch.models.convert.params_from_jax` carries the
  reference's weights across unchanged;
* ``forward(params, batch)``: the full forward, ``(logits, aux, label_mask)``;
* ``loss(params, batch)``: next-token cross entropy plus the MoE aux
  losses, ``(loss, metrics)``. Forward only: the port has no backward pass
  or optimizer yet;
* ``init_cache(batch, max_len, device="cuda")`` / ``forward_with_cache`` /
  ``decode_step``: the serving path with fixed-capacity caches, at one
  scalar position or at per-slot positions (a ``(B,)`` ``cache["pos"]``).

Families:
  dense   pre-norm GQA (or MLA) attention + SwiGLU (granite, qwen3,
          internlm2, minicpm3)
  moe     attention + MoE FFN (arctic: + parallel dense FFN; qwen2-moe:
          + shared experts)
  ssm     pure Mamba2/SSD (mamba2-130m, spatial-lm)
  hybrid  Mamba2 backbone + ONE weight-shared attention block applied every
          ``hybrid_attn_every`` layers, with per-site KV caches (zamba2)
  encdec  whisper: stub audio frames -> encoder; decoder with cross-attention
  vlm     pixtral: stub ViT patch embeddings + adapter, decoder backbone

On a mesh (DTensor parameters placed by the reference's partition rules)
each layer's weights are gathered over the FSDP axes for their use
(``gather_fsdp``), and the residual stream keeps the batch on the batch
axes and is whole over 'model' between blocks (``batch_sharded``: the
all-reduce that ends a tensor-parallel block). Without a mesh both are the
identity.

Parameters are stored in ``param_dtype`` and cast to the activation dtype
at each use; logits come out in the activation dtype. The layer stack is a
Python loop (no ``scan``, no ``jit``): PyTorch runs eagerly, so the
config's ``remat`` and ``unroll_layers`` knobs change nothing here and are
ignored. Caches are written in place.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from .._device import torch_device
from ..configs.base import ModelConfig
from ..sharding.dtensor import batch_sharded, embed_lookup, gather_fsdp, is_dtensor
from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import (MetaGenerator, cross_entropy_loss, dense_init, dtype_of, embed_init,
                     init_mlp, mlp, rms_norm, sinusoidal_embedding)


def _layer(tree, i: int):
    """Entry ``i`` of a stacked tree: views, so in-place writes land in the stack."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _weights(params: dict, key: str, layer: int | None = None):
    """``params[key]`` (entry ``layer`` of a stacked tree), and on a mesh
    gathered whole over the FSDP axes for its use (:func:`gather_fsdp`)."""
    tree = params.get(key)
    if tree is None:
        return None
    if layer is not None:
        tree = _layer(tree, layer)
    leaf = tree
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return gather_fsdp(tree) if is_dtensor(leaf) else tree


def _input(batch: dict, key: str, device: torch.device, dtype=torch.long) -> torch.Tensor:
    t = batch[key]
    if not torch.is_tensor(t):
        t = torch.from_numpy(np.ascontiguousarray(t))
    return t.to(device=device, dtype=dtype)


def _ones(stack, d, dtype, device):
    return torch.ones((*stack, d), dtype=dtype, device=device)


# ----------------------------------------------------------------- layer init
def _init_decoder_layer(cfg: ModelConfig, gen, dtype, stack) -> dict:
    dev = gen.device
    p: dict = {"ln1": _ones(stack, cfg.d_model, dtype, dev)}
    if cfg.family in ("ssm", "hybrid"):
        p["ssm"] = ssm_mod.init_ssm(gen, cfg, dtype, stack=stack)
        return p
    if cfg.mla is not None:
        p["attn"] = attn.init_mla(gen, cfg, dtype, stack=stack)
    else:
        p["attn"] = attn.init_gqa(gen, cfg, dtype, stack=stack)
    p["ln2"] = _ones(stack, cfg.d_model, dtype, dev)
    if cfg.family == "moe":
        p["moe"] = moe_mod.init_moe(gen, cfg, dtype, stack=stack)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, stack=stack)
    if cfg.family == "encdec":  # decoder layers gain cross-attention
        p["ln_cross"] = _ones(stack, cfg.d_model, dtype, dev)
        p["cross"] = attn.init_cross_attention(gen, cfg, dtype, stack=stack)
    return p


def _init_attn_mlp_block(cfg: ModelConfig, gen, dtype, stack=()) -> dict:
    """An encoder layer, or zamba2's weight-shared attention+MLP block
    (hidden-only input, as in the reference)."""
    dev = gen.device
    return {
        "ln1": _ones(stack, cfg.d_model, dtype, dev),
        "attn": attn.init_gqa(gen, cfg, dtype, stack=stack),
        "ln2": _ones(stack, cfg.d_model, dtype, dev),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, stack=stack),
    }


def _device(device) -> torch.device:
    """:func:`torch_device`, plus ``"meta"``: shapes and dtypes only, no
    allocation (the dry run's parameters and caches)."""
    return torch.device("meta") if str(device) == "meta" else torch_device(device)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    dev = _device(device)
    if dev.type == "meta":
        gen = MetaGenerator()
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    pdt = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    params: dict = {
        "embed": embed_init(gen, (cfg.vocab, d), pdt),
        "final_norm": torch.ones((d,), dtype=pdt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, cfg.vocab), 0, dtype=pdt)
    params["layers"] = _init_decoder_layer(cfg, gen, pdt, (cfg.n_layers,))
    if cfg.family == "hybrid":
        params["shared_attn"] = _init_attn_mlp_block(cfg, gen, pdt)
    if cfg.family == "encdec":
        params["encoder"] = {
            "layers": _init_attn_mlp_block(cfg, gen, pdt, (cfg.n_encoder_layers,)),
            "final_norm": torch.ones((d,), dtype=pdt, device=dev),
        }
    if cfg.frontend is not None:
        fdim = cfg.frontend_dim or d
        params["frontend_adapter"] = dense_init(gen, (fdim, d), 0, dtype=pdt)
    return params


# ------------------------------------------------------------- layer forward
def _attn_block(cfg, lp, x, positions, cache=None, cache_pos=None):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    fwd = attn.mla_forward if cfg.mla is not None else attn.gqa_forward
    out, _ = fwd(cfg, lp["attn"], h, positions, cache=cache, cache_pos=cache_pos)
    return batch_sharded(x + out)


def _ffn_block(cfg, lp, x):
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        out, aux = moe_mod.moe_block(cfg, lp["moe"], h)
        return batch_sharded(x + out), aux
    return batch_sharded(x + mlp(lp["mlp"], h)), {}


def _shared_block(cfg, sp, x, positions, cache=None, cache_pos=None, causal=True):
    """Attention + MLP, pre-norm: zamba2's shared block and an encoder layer."""
    h = rms_norm(x, sp["ln1"], cfg.norm_eps)
    out, _ = attn.gqa_forward(cfg, sp["attn"], h, positions, causal=causal,
                              cache=cache, cache_pos=cache_pos)
    x = batch_sharded(x + out)
    return batch_sharded(x + mlp(sp["mlp"], rms_norm(x, sp["ln2"], cfg.norm_eps)))


def _decoder_layer(cfg, lp, x, positions, *, shared=None, layer_idx=0, cache=None,
                   cache_pos=None, sites=None, enc_out=None, cross_kv=None):
    """One decoder layer; returns (x, aux). A given layer cache, and the
    hybrid's site caches, are written in place."""
    if cfg.family in ("ssm", "hybrid"):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if cache is not None and x.shape[1] == 1:
            out, _ = ssm_mod.ssm_decode_step(cfg, lp["ssm"], h, cache)
        else:
            out, _ = ssm_mod.ssm_forward(cfg, lp["ssm"], h, cache=cache)
        x = batch_sharded(x + out)
        every = cfg.hybrid_attn_every
        if cfg.family == "hybrid" and shared is not None and layer_idx % every == every - 1:
            site = None if sites is None else _layer(sites, layer_idx // every)
            x = _shared_block(cfg, shared, x, positions, cache=site, cache_pos=cache_pos)
        return x, {}
    x = _attn_block(cfg, lp, x, positions, cache=cache, cache_pos=cache_pos)
    if cfg.family == "encdec":
        h = rms_norm(x, lp["ln_cross"], cfg.norm_eps)
        x = batch_sharded(x + attn.cross_attention(cfg, lp["cross"], h, enc_kv=cross_kv,
                                                     enc_out=enc_out))
    return _ffn_block(cfg, lp, x)


# --------------------------------------------------------------- embeddings
def _embed_inputs(cfg, params, batch):
    """Returns (x (B,S,d) activations, positions (S,), label_mask or None)."""
    adt = dtype_of(cfg.dtype)
    dev = params["embed"].device
    tokens = _input(batch, "tokens", dev)
    x = embed_lookup(params["embed"], tokens).to(adt)
    label_mask = None
    if cfg.family == "vlm":
        vis = _input(batch, "patches", dev, adt) @ _weights(params, "frontend_adapter").to(adt)
        x = torch.cat([vis, x], dim=1)
        label_mask = torch.cat([torch.zeros(vis.shape[:2], dtype=torch.bool, device=dev),
                                torch.ones(tokens.shape, dtype=torch.bool, device=dev)], dim=1)
    positions = torch.arange(x.shape[1], device=dev)
    return x, positions, label_mask


def _encode(cfg, params, batch):
    """Whisper encoder over stub frame embeddings: adapter, sinusoidal
    positions, non-causal attention layers, final norm."""
    adt = dtype_of(cfg.dtype)
    dev = params["embed"].device
    x = _input(batch, "frames", dev, adt) @ _weights(params, "frontend_adapter").to(adt)
    x = x + sinusoidal_embedding(x.shape[1], cfg.d_model, dev)[None].to(adt)
    positions = torch.arange(x.shape[1], device=dev)
    enc = params["encoder"]
    for i in range(cfg.n_encoder_layers):
        x = _shared_block(cfg, _weights(enc, "layers", i), x, positions, causal=False)
    return rms_norm(x, enc["final_norm"], cfg.norm_eps)


def _logits(cfg, params, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = _weights(params, "embed").T if cfg.tie_embeddings else _weights(params, "lm_head")
    return x @ head.to(x.dtype)


# ------------------------------------------------------------------- forward
def forward(cfg: ModelConfig, params: dict, batch: dict):
    """Training/prefill-style full forward. Returns (logits, aux, label_mask);
    ``aux`` holds the MoE losses summed over layers (empty for the rest)."""
    x, positions, label_mask = _embed_inputs(cfg, params, batch)
    enc_out = _encode(cfg, params, batch) if cfg.family == "encdec" else None
    shared = _weights(params, "shared_attn")
    aux: dict = {}
    if cfg.family == "moe":
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        aux = {"moe_aux_loss": zero, "router_z_loss": zero}
    for i in range(cfg.n_layers):
        x, aux_i = _decoder_layer(cfg, _weights(params, "layers", i), x, positions,
                                  shared=shared, layer_idx=i, enc_out=enc_out)
        aux = {k: aux[k] + v for k, v in aux_i.items()} if aux_i else aux
    return _logits(cfg, params, x), aux, label_mask


def loss_fn(cfg: ModelConfig, params: dict, batch: dict):
    """Next-token cross entropy (+ MoE aux). Returns (loss, metrics).

    Labels default to the tokens shifted by one (the last one ignored);
    for the vlm family the patch positions are ignored too."""
    logits, aux, label_mask = forward(cfg, params, batch)
    if batch.get("labels") is not None:
        labels = _input(batch, "labels", logits.device)
    else:
        tokens = _input(batch, "tokens", logits.device)
        labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)], dim=1)
        if label_mask is not None:  # vlm: ignore labels for the patches
            pad = torch.full((tokens.shape[0], logits.shape[1] - labels.shape[1]), -1,
                             dtype=labels.dtype, device=labels.device)
            labels = torch.cat([pad, labels], dim=1)
    ce, count = cross_entropy_loss(logits, labels, impl=cfg.ce_impl)
    total = ce
    metrics = {"ce_loss": ce, "tokens": count}
    for k, v in aux.items():
        total = total + v
        metrics[k] = v
    metrics["loss"] = total
    return total, metrics


# ------------------------------------------------------------------- serving
def _stacked(tree: dict, n: int) -> dict:
    return {k: torch.zeros((n, *a.shape), dtype=a.dtype, device=a.device)
            for k, a in tree.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda") -> dict:
    dev = _device(device)
    adt = dtype_of(cfg.dtype)
    cache: dict = {"pos": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.family in ("ssm", "hybrid"):
        cache["layers"] = _stacked(ssm_mod.init_ssm_cache(cfg, batch, adt, dev), cfg.n_layers)
        if cfg.family == "hybrid":
            n_sites = cfg.n_layers // cfg.hybrid_attn_every
            cache["sites"] = _stacked(attn.init_gqa_cache(cfg, batch, max_len, adt, dev),
                                      n_sites)
        return cache
    init = attn.init_mla_cache if cfg.mla is not None else attn.init_gqa_cache
    cache["layers"] = _stacked(init(cfg, batch, max_len, adt, dev), cfg.n_layers)
    if cfg.family == "encdec":
        enc_len = max_len // cfg.frontend_downsample
        shape = (cfg.n_layers, batch, enc_len, cfg.n_heads, cfg.resolved_head_dim)
        cache["cross"] = {k: torch.zeros(shape, dtype=adt, device=dev) for k in ("k", "v")}
    return cache


def forward_with_cache(cfg: ModelConfig, params: dict, batch: dict, cache: dict):
    """Prefill (S>=1) or decode (S==1) against the cache at ``cache['pos']``
    (a scalar, or one position per slot). Returns (logits, new_cache).

    Cache rows are written into ``cache``'s tensors in place; the new cache
    shares them and carries the advanced position. For encdec, a batch with
    ``"frames"`` replaces ``cache["cross"]`` with the encoder's K/V at the
    frames' length; without frames the cross cache stays as it is (zeros
    in a fresh cache, which is how the reference's server runs whisper)."""
    adt = dtype_of(cfg.dtype)
    dev = params["embed"].device
    tokens = _input(batch, "tokens", dev)
    pos0 = cache["pos"]
    x = embed_lookup(params["embed"], tokens).to(adt)
    if cfg.family == "vlm" and "patches" in batch:
        vis = _input(batch, "patches", dev, adt) @ _weights(params, "frontend_adapter").to(adt)
        x = torch.cat([vis, x], dim=1)
    s = x.shape[1]
    steps = torch.arange(s, device=dev)
    if pos0.dim() == 0:
        cache_pos = int(pos0)          # one host read per call, not per layer
        positions = cache_pos + steps
    else:
        # per-slot positions (continuous batching): (B, S), one row per slot
        cache_pos = pos0
        positions = pos0[:, None] + steps[None, :]
    new_cache = dict(cache)
    if cfg.family == "encdec" and "frames" in batch:
        # prefill: encode and cache each layer's cross K/V
        enc_out = _encode(cfg, params, batch)
        kvs = [attn.make_cross_kv(cfg, _weights(params, "layers", i)["cross"], enc_out)
               for i in range(cfg.n_layers)]
        new_cache["cross"] = {k: torch.stack([kv[k] for kv in kvs]) for k in ("k", "v")}
    shared = _weights(params, "shared_attn")
    for i in range(cfg.n_layers):
        ckv = _layer(new_cache["cross"], i) if cfg.family == "encdec" else None
        x, _ = _decoder_layer(cfg, _weights(params, "layers", i), x, positions, shared=shared,
                              layer_idx=i, cache=_layer(cache["layers"], i),
                              cache_pos=cache_pos, sites=cache.get("sites"), cross_kv=ckv)
    new_cache["pos"] = pos0 + s
    return _logits(cfg, params, x), new_cache


def decode_step(cfg, params, tokens, cache):
    """One-token decode: tokens (B, 1) -> (logits (B,1,V), cache)."""
    return forward_with_cache(cfg, params, {"tokens": tokens}, cache)


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., dict]
    forward: Callable[[dict, dict], Any]
    loss: Callable[[dict, dict], Any]
    init_cache: Callable[..., dict]
    forward_with_cache: Callable[[dict, dict, dict], Any]
    decode_step: Callable[[dict, Any, dict], Any]


def build_model(cfg: ModelConfig) -> Model:
    return Model(
        cfg=cfg,
        init=functools.partial(init_params, cfg),
        forward=functools.partial(forward, cfg),
        loss=functools.partial(loss_fn, cfg),
        init_cache=functools.partial(init_cache, cfg),
        forward_with_cache=functools.partial(forward_with_cache, cfg),
        decode_step=functools.partial(decode_step, cfg),
    )


def flash_calls(cfg: ModelConfig) -> int:
    """Attention calls of one ``forward`` that reach the flash kernel: one a
    layer (whisper's encoder layers too), one a site of a hybrid's shared
    block, none for an SSM or under another ``attn_impl``."""
    if cfg.attn_impl != "flash":
        return 0
    return {"dense": cfg.n_layers, "moe": cfg.n_layers, "vlm": cfg.n_layers,
            "encdec": cfg.n_layers + cfg.n_encoder_layers,
            "hybrid": cfg.n_layers // max(cfg.hybrid_attn_every, 1), "ssm": 0}[cfg.family]
