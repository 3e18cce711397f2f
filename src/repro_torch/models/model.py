"""Model construction, dense family (``repro/models/model.py``).

``build_model(cfg)`` returns a :class:`Model` whose members are plain
functions over dicts of tensors, as in the reference:

* ``init(seed, device="cuda")``: parameters, drawn on ``device`` from a
  seeded :class:`torch.Generator`. Layer weights are stacked with a leading
  ``n_layers`` axis and keep the reference's ``(d_in, d_out)`` layout, so
  :func:`repro_torch.models.convert.params_from_jax` carries the
  reference's weights across unchanged;
* ``forward(params, batch)``: the full forward, ``(logits, aux, label_mask)``;
* ``init_cache(batch, max_len, device="cuda")`` / ``forward_with_cache`` /
  ``decode_step``: the serving path with fixed-capacity caches, at one
  scalar position or at per-slot positions (a ``(B,)`` ``cache["pos"]``).

Parameters are stored in ``param_dtype`` and cast to the activation dtype
at each use; logits come out in the activation dtype. The layer stack is a
Python loop (no ``scan``, no ``jit``): PyTorch runs eagerly. Only the dense
family (pre-norm GQA attention + SwiGLU: qwen3, internlm2, granite) is
ported; :func:`build_model` raises for the others. Training (``loss``)
waits for its slice.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from .._device import torch_device
from ..configs.base import ModelConfig
from . import attention as attn
from .layers import dtype_of, dense_init, embed_init, init_mlp, mlp, rms_norm


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.mla is not None:
        what = "MLA attention" if cfg.mla is not None else f"the {cfg.family!r} family"
        raise NotImplementedError(
            f"{cfg.name}: {what} is not ported to PyTorch yet "
            "(ROADMAP.md, modules to port, item 9)")


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree: views, so in-place writes land in the stack."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _tokens(batch: dict, device: torch.device) -> torch.Tensor:
    t = batch["tokens"]
    if not torch.is_tensor(t):
        t = torch.from_numpy(np.ascontiguousarray(t))
    return t.to(device=device, dtype=torch.long)


# ----------------------------------------------------------------- init
def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    _check_ported(cfg)
    dev = torch_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pdt = dtype_of(cfg.param_dtype)
    n, d = cfg.n_layers, cfg.d_model
    params: dict = {
        "embed": embed_init(gen, (cfg.vocab, d), pdt),
        "final_norm": torch.ones((d,), dtype=pdt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, cfg.vocab), 0, dtype=pdt)
    params["layers"] = {
        "ln1": torch.ones((n, d), dtype=pdt, device=dev),
        "attn": attn.init_gqa(gen, cfg, pdt, stack=(n,)),
        "ln2": torch.ones((n, d), dtype=pdt, device=dev),
        "mlp": init_mlp(gen, d, cfg.d_ff, pdt, stack=(n,)),
    }
    return params


# ------------------------------------------------------------- layer forward
def _attn_block(cfg, lp, x, positions, cache=None, cache_pos=None):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    out, _ = attn.gqa_forward(cfg, lp["attn"], h, positions, cache=cache, cache_pos=cache_pos)
    return x + out


def _ffn_block(cfg, lp, x):
    return x + mlp(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps))


def _decoder_layer(cfg, lp, x, positions, *, cache=None, cache_pos=None):
    """One dense decoder layer. A given layer cache is written in place."""
    x = _attn_block(cfg, lp, x, positions, cache=cache, cache_pos=cache_pos)
    return _ffn_block(cfg, lp, x)


def _embed_inputs(cfg, params, batch):
    """Returns (x (B,S,d) activations, positions (S,), label_mask or None)."""
    tokens = _tokens(batch, params["embed"].device)
    x = params["embed"][tokens].to(dtype_of(cfg.dtype))
    positions = torch.arange(x.shape[1], device=x.device)
    return x, positions, None


def _logits(cfg, params, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)


# ------------------------------------------------------------------- forward
def forward(cfg: ModelConfig, params: dict, batch: dict):
    """Training/prefill-style full forward. Returns (logits, aux, label_mask)."""
    x, positions, label_mask = _embed_inputs(cfg, params, batch)
    for i in range(cfg.n_layers):
        x = _decoder_layer(cfg, _layer(params["layers"], i), x, positions)
    return _logits(cfg, params, x), {}, label_mask


# ------------------------------------------------------------------- serving
def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda") -> dict:
    dev = torch_device(device)
    layer = attn.init_gqa_cache(cfg, batch, max_len, dtype_of(cfg.dtype), dev)
    return {
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
        "layers": {k: torch.zeros((cfg.n_layers, *a.shape), dtype=a.dtype, device=dev)
                   for k, a in layer.items()},
    }


def forward_with_cache(cfg: ModelConfig, params: dict, batch: dict, cache: dict):
    """Prefill (S>=1) or decode (S==1) against the cache at ``cache['pos']``
    (a scalar, or one position per slot). Returns (logits, new_cache).

    The K/V rows are written into ``cache``'s tensors in place; the new
    cache shares them and carries the advanced position."""
    tokens = _tokens(batch, params["embed"].device)
    pos0 = cache["pos"]
    s = tokens.shape[1]
    x = params["embed"][tokens].to(dtype_of(cfg.dtype))
    steps = torch.arange(s, device=x.device)
    if pos0.dim() == 0:
        cache_pos = int(pos0)          # one host read per call, not per layer
        positions = cache_pos + steps
    else:
        # per-slot positions (continuous batching): (B, S), one row per slot
        cache_pos = pos0
        positions = pos0[:, None] + steps[None, :]
    for i in range(cfg.n_layers):
        x = _decoder_layer(cfg, _layer(params["layers"], i), x, positions,
                           cache=_layer(cache["layers"], i), cache_pos=cache_pos)
    new_cache = dict(cache)
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
    init_cache: Callable[..., dict]
    forward_with_cache: Callable[[dict, dict, dict], Any]
    decode_step: Callable[[dict, Any, dict], Any]


def build_model(cfg: ModelConfig) -> Model:
    _check_ported(cfg)
    return Model(
        cfg=cfg,
        init=functools.partial(init_params, cfg),
        forward=functools.partial(forward, cfg),
        init_cache=functools.partial(init_cache, cfg),
        forward_with_cache=functools.partial(forward_with_cache, cfg),
        decode_step=functools.partial(decode_step, cfg),
    )
