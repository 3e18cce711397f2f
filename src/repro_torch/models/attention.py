"""Attention blocks with explicit caches (``repro/models/attention.py``):
GQA (+qk-norm), MLA (latent attention) and cross-attention.

The ``impl`` knob picks the plain einsum (``ref``), the online-softmax
scan over KV blocks in plain torch (``blocked``) or the flash-attention
kernel (``flash``: :func:`repro_torch.kernels.flash_attention.attention`,
the CUDA kernel on a CUDA tensor). As in the reference, ``blocked`` and
``flash`` run only where no per-query positions and no valid-length mask
are given: the full forward and the full-capacity prefill. Every other
cached call takes ``ref``, and cross-attention always does. The kernel
takes one head dim for q, k and v, so MLA (whose q/k heads are wider than
its v heads) runs ``ref`` or ``blocked``.

Unlike the reference's pure functions, cached calls write the new K/V into
the cache tensors in place (the reference's ``dynamic_update_slice``
returns a new array; here that copy would double the cache's memory) and
return the same tensors as the new cache.
"""

from __future__ import annotations

import functools
import math

import torch

from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..kernels.flash_attention import attention as flash_attention_op
from ..sharding.dtensor import BATCH_AXES, axes_placements, is_dtensor, split_ready, write_rows
from .layers import apply_rope, dense_init, rms_norm

NEG_INF = -1e30


def _sdpa_blocked(q, k, v, *, causal: bool, block_k: int = 1024):
    """Online-softmax attention over KV blocks in plain torch: the (S, Sk)
    logits are never materialised. q: (B,S,Hq,D), k/v: (B,Sk,Hkv,D)."""
    b, s, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    group = hq // hkv
    if sk % block_k:
        block_k = math.gcd(sk, block_k) or sk
    nb = sk // block_k
    scale = 1.0 / math.sqrt(d)
    qg = split_ready(q, 2, hkv).reshape(b, s, hkv, group, d)
    rows = torch.arange(s, device=q.device)[:, None] + (sk - s)  # decode-aligned diagonal
    m = torch.full((b, hkv, group, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, group, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, group, s, dv), dtype=torch.float32, device=q.device)
    for bi in range(nb):
        kblk = k[:, bi * block_k:(bi + 1) * block_k]
        vblk = v[:, bi * block_k:(bi + 1) * block_k]
        logits = torch.einsum("bshgd,bthd->bhgst", qg.float(), kblk.float()) * scale
        if causal:
            cols = bi * block_k + torch.arange(block_k, device=q.device)[None, :]
            logits = logits.masked_fill(~(cols <= rows), NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgst,bthd->bhgsd", p.to(vblk.dtype).float(), vblk.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, dv).to(q.dtype)


def _flash(q, k, v, *, causal: bool):
    """The flash op on (B,S,H,D) tensors: (B,H,S,D) views, which the kernel
    takes with their strides as they are."""
    out = flash_attention_op(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                             causal=causal)
    return out.transpose(1, 2)


def _sdpa_local(q, k, v, *, causal: bool, q_pos=None, k_valid_len=None, impl: str = "ref",
                q_head0: int = 0, group: int = 0):
    """q: (B,S,Hq,D), k/v: (B,Sk,Hkv,D) -> (B,S,Hq,D) on plain tensors.

    ``q_pos``: absolute positions of queries (for decode masking);
    ``k_valid_len``: number of valid cache slots (a scalar, or (B,1,1) per
    slot): keys beyond are masked out. ``group`` > 0 says that q is a
    block of query heads starting at global head ``q_head0`` while k and v
    hold every kv head (a rank's block on a mesh): each local query head
    ``i`` then reads kv head ``(q_head0 + i) // group`` (gathered here, one
    kv head per query head), not ``i // group``.
    """
    if group:
        idx = (q_head0 + torch.arange(q.shape[2], device=q.device)) // group
        k, v = k[:, :, idx], v[:, :, idx]
    b, s, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if impl == "blocked" and k_valid_len is None and q_pos is None:
        return _sdpa_blocked(q, k, v, causal=causal)
    if impl == "flash" and k_valid_len is None and q_pos is None:
        return _flash(q, k, v, causal=causal)
    group = hq // hkv
    qg = q.reshape(b, s, hkv, group, d)
    logits = torch.einsum("bshgd,bthd->bhgst", qg.float(), k.float())
    logits = logits / math.sqrt(d)
    rows = torch.arange(s, device=q.device)[:, None] if q_pos is None else q_pos[..., None]
    cols = torch.arange(sk, device=q.device)[None, :]
    mask = None
    if causal:
        offset = 0 if q_pos is not None else (sk - s)
        mask = cols <= rows + offset
    if k_valid_len is not None:
        kmask = cols < k_valid_len
        mask = kmask if mask is None else (mask & kmask)
    if mask is not None:
        while mask.dim() < 3:   # -> (B|1, s|1, sk)
            mask = mask[None]
        mask = mask[:, None, None]  # (B|1, 1, 1, s|1, sk)
        logits = logits.masked_fill_(~mask, NEG_INF)
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", p, v)
    return out.reshape(b, s, hq, v.shape[-1])


def _sdpa(q, k, v, *, causal: bool, q_pos=None, k_valid_len=None, impl: str = "ref"):
    """:func:`_sdpa_local`, and on a mesh the same on each rank's own block
    (``local_map``; the flash kernel takes plain tensors, and the plain
    version's head grouping has no sharding rule): batch on the batch axes,
    query heads on 'model'. Where the kv heads divide 'model' too they
    shard the same way, and a local query head's kv head is its local index
    over the ratio; where they do not, k and v are gathered whole over
    'model' (an explicit all-gather) and each rank reads the kv heads of
    its own query heads. A cache sharded on its sequence (SP decode) stays
    so: :func:`_sdpa_sequence_parallel`. The output is placed as q is."""
    kw = dict(causal=causal, k_valid_len=k_valid_len, impl=impl)
    if not is_dtensor(q):
        return _sdpa_local(q, k, v, q_pos=q_pos, **kw)
    if torch.is_tensor(k_valid_len):
        raise NotImplementedError("per-slot valid lengths take a cache on one device")
    if is_dtensor(k) and any(isinstance(p, Shard) and p.dim == 1 for p in k.placements):
        return _sdpa_sequence_parallel(q, k, v, causal=causal, q_pos=q_pos,
                                       k_valid_len=k_valid_len)
    mesh = q.device_mesh
    hq, hkv = q.shape[2], k.shape[2]
    qpl = axes_placements(mesh, q.shape, (BATCH_AXES, None, "model", None))
    kpl = axes_placements(mesh, k.shape, (BATCH_AXES, None, "model", None))
    names = mesh.mesh_dim_names
    if "model" in names and qpl[names.index("model")] != kpl[names.index("model")]:
        m = names.index("model")
        kw.update(group=hq // hkv, q_head0=mesh.get_local_rank(m) * (hq // mesh.size(m)))
    args, in_pl = (q, k, v), [qpl, kpl, kpl]
    if q_pos is not None:
        if not is_dtensor(q_pos):
            q_pos = DTensor.from_local(q_pos, mesh, [Replicate()] * mesh.ndim, run_check=False)
        args, in_pl = args + (q_pos,), in_pl + [(Replicate(),) * mesh.ndim]
    fn = functools.partial(_sdpa_local, **kw) if q_pos is None else \
        (lambda q_, k_, v_, pos_: _sdpa_local(q_, k_, v_, q_pos=pos_, **kw))
    return local_map(fn, out_placements=[*qpl], in_placements=tuple(in_pl),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def _sdpa_sequence_parallel(q, k, v, *, causal: bool, q_pos=None, k_valid_len=None):
    """Attention over a cache whose sequence is sharded (SP decode), as the
    reference's partitioner runs it: each rank attends to its own block of
    keys, and the softmax's max and sum and the weighted values are reduced
    across the mesh dims that split the sequence (all-reduces of (B, H, S)
    statistics and of the (B, S, H, D) output, not the cache). q is made
    whole over those dims; batch and heads keep the cache's sharding."""
    import torch.distributed._functional_collectives as funcol

    mesh = k.device_mesh
    seq = [i for i, p in enumerate(k.placements) if isinstance(p, Shard) and p.dim == 1]
    kpl = tuple(k.placements)
    qpl = tuple(Replicate() if i in seq else p for i, p in enumerate(kpl))
    groups = [mesh.get_group(i) for i in seq]
    sk_all, s = k.shape[1], q.shape[1]
    block = sk_all
    for i in seq:
        block //= mesh.size(i)
    col0 = 0
    for i in seq:                      # this rank's first key, mesh dims in order
        col0 = col0 * mesh.size(i) + mesh.get_local_rank(i)
    col0 *= block

    def reduce(t, op):
        for g in groups:
            t = funcol.all_reduce(t, op, g)
        return t.wait() if hasattr(t, "wait") else t

    def local(q_, k_, v_, *pos):
        b, _, hq, d = q_.shape
        hkv = k_.shape[2]
        qg = q_.reshape(b, s, hkv, hq // hkv, d)
        logits = torch.einsum("bshgd,bthd->bhgst", qg.float(), k_.float()) / math.sqrt(d)
        rows = torch.arange(s, device=q_.device)[:, None] if not pos else pos[0][..., None]
        cols = col0 + torch.arange(k_.shape[1], device=q_.device)[None, :]
        mask = None
        if causal:
            mask = cols <= rows + (0 if pos else sk_all - s)
        if k_valid_len is not None:
            kmask = cols < k_valid_len
            mask = kmask if mask is None else (mask & kmask)
        if mask is not None:
            while mask.dim() < 3:
                mask = mask[None]
            logits = logits.masked_fill_(~mask[:, None, None], NEG_INF)
        m = reduce(logits.amax(dim=-1, keepdim=True), "max")
        p = torch.exp(logits - m)
        p = (p / reduce(p.sum(dim=-1, keepdim=True), "sum")).to(v_.dtype)
        out = reduce(torch.einsum("bhgst,bthd->bshgd", p, v_), "sum")
        return out.reshape(b, s, hq, v_.shape[-1])

    args, in_pl = [q, k, v], [qpl, kpl, kpl]
    if q_pos is not None:
        if not is_dtensor(q_pos):
            q_pos = DTensor.from_local(q_pos, mesh, [Replicate()] * mesh.ndim, run_check=False)
        args.append(q_pos)
        in_pl.append((Replicate(),) * mesh.ndim)
    return local_map(local, out_placements=[*qpl], in_placements=tuple(in_pl),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def _heads(t, h: int, hd: int):
    """(B, S, h * hd) -> (B, S, h, hd)."""
    return split_ready(t, -1, h).reshape(*t.shape[:2], h, hd)


def _update_slots(cache_arr, new, pos):
    """Per-slot cache write, in place: ``new[b]`` lands in ``cache_arr[b]``
    at row offset ``pos[b]`` along axis 1 (continuous batching, where every
    batch slot sits at its own decode position). Like the reference's
    ``dynamic_update_slice``, an offset past the end is clamped so the
    write fits."""
    if is_dtensor(cache_arr):
        raise NotImplementedError("per-slot cache writes take a cache on one device, "
                                  "not a DTensor cache on a mesh")
    n, s = cache_arr.shape[1], new.shape[1]
    start = pos.long().clamp(0, n - s)
    rows = start[:, None] + torch.arange(s, device=pos.device)
    slots = torch.arange(pos.shape[0], device=pos.device)[:, None]
    cache_arr[slots, rows] = new.to(cache_arr.dtype)
    return cache_arr


# ----------------------------------------------------------------------- GQA
def init_gqa(gen, cfg, dtype, stack=()) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    s, ax = tuple(stack), len(stack)
    p = {
        "wq": dense_init(gen, (*s, d, hq * hd), ax, dtype=dtype),
        "wk": dense_init(gen, (*s, d, hkv * hd), ax, dtype=dtype),
        "wv": dense_init(gen, (*s, d, hkv * hd), ax, dtype=dtype),
        "wo": dense_init(gen, (*s, hq * hd, d), ax, dtype=dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*s, hd), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.ones((*s, hd), dtype=dtype, device=gen.device)
    return p


def gqa_forward(cfg, p, x, positions, *, causal=True, cache=None, cache_pos=None,
                use_rope=True):
    """Full-sequence or cached attention.

    cache: None, or dict {k: (B, Smax, Hkv, D), v: ...}; when given, the new
    K/V are written at ``cache_pos`` (an int, or a (B,) tensor of per-slot
    offsets) and attention runs over the cache. Returns (out, new_cache).
    """
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = _heads(x @ p["wq"].to(x.dtype), hq, hd)
    k = _heads(x @ p["wk"].to(x.dtype), hkv, hd)
    v = _heads(x @ p["wv"].to(x.dtype), hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    new_cache = None
    if cache is not None:
        if torch.is_tensor(cache_pos) and cache_pos.dim() != 0:
            # per-slot positions: each slot writes K/V at its own offset and
            # masks its own valid length; positions must already be (B, S)
            kc = _update_slots(cache["k"], k, cache_pos)
            vc = _update_slots(cache["v"], v, cache_pos)
            out = _sdpa(
                q, kc.to(x.dtype), vc.to(x.dtype), causal=True,
                q_pos=positions, k_valid_len=(cache_pos + s)[:, None, None],
                impl="ref",
            )
            return out.reshape(b, s, hq * hd) @ p["wo"].to(x.dtype), {"k": kc, "v": vc}
        pos0 = int(cache_pos)
        smax = cache["k"].shape[1]
        pos = min(max(pos0, 0), smax - s)   # dynamic_update_slice clamps the offset
        kc, vc = cache["k"], cache["v"]
        write_rows(kc, k, pos)
        write_rows(vc, v, pos)
        new_cache = {"k": kc, "v": vc}
        if s == smax:
            # full-capacity prefill (static condition): attention over the
            # fresh K/V is equivalent and admits the blocked/flash impls
            out = _sdpa(q, k, v, causal=True, impl=cfg.attn_impl)
        else:
            qpos = positions if positions.dim() else positions[None]
            out = _sdpa(
                q, kc.to(x.dtype), vc.to(x.dtype), causal=True,
                q_pos=qpos, k_valid_len=pos0 + s, impl="ref",
            )
    else:
        out = _sdpa(q, k, v, causal=causal, impl=cfg.attn_impl)
    return out.reshape(b, s, hq * hd) @ p["wo"].to(x.dtype), new_cache


def init_gqa_cache(cfg, batch: int, max_len: int, dtype, device) -> dict:
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, max_len, hkv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, hkv, hd), dtype=dtype, device=device),
    }


# ----------------------------------------------------------------------- MLA
def init_mla(gen, cfg, dtype, stack=()) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk_dim = m.nope_head_dim + m.rope_head_dim
    s, ax = tuple(stack), len(stack)
    dev = gen.device
    return {
        "wq_a": dense_init(gen, (*s, d, m.q_lora_rank), ax, dtype=dtype),
        "q_norm": torch.ones((*s, m.q_lora_rank), dtype=dtype, device=dev),
        "wq_b": dense_init(gen, (*s, m.q_lora_rank, h * qk_dim), ax, dtype=dtype),
        "wkv_a": dense_init(gen, (*s, d, m.kv_lora_rank + m.rope_head_dim), ax, dtype=dtype),
        "kv_norm": torch.ones((*s, m.kv_lora_rank), dtype=dtype, device=dev),
        "wkv_b": dense_init(gen, (*s, m.kv_lora_rank, h * (m.nope_head_dim + m.v_head_dim)),
                            ax, dtype=dtype),
        "wo": dense_init(gen, (*s, h * m.v_head_dim, d), ax, dtype=dtype),
    }


def _mla_qkv(cfg, p, x, positions):
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    q_lat = rms_norm(x @ p["wq_a"].to(x.dtype), p["q_norm"], cfg.norm_eps)
    q = _heads(q_lat @ p["wq_b"].to(x.dtype), h, m.nope_head_dim + m.rope_head_dim)
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    kv_a = x @ p["wkv_a"].to(x.dtype)
    c_kv, k_rope = kv_a[..., :m.kv_lora_rank], kv_a[..., m.kv_lora_rank:]
    c_kv = rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)                      # (B,S,r)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)  # (B,S,1,rd)
    return q_nope, q_rope, c_kv, k_rope


def _mla_attend(cfg, p, q_nope, q_rope, c_kv, k_rope, *, q_pos=None, k_valid_len=None):
    m = cfg.mla
    h = cfg.n_heads
    b, s = q_nope.shape[:2]
    kv = _heads(c_kv.to(q_nope.dtype) @ p["wkv_b"].to(q_nope.dtype), h,
                m.nope_head_dim + m.v_head_dim)
    k_nope, v = kv[..., :m.nope_head_dim], kv[..., m.nope_head_dim:]
    k = torch.cat([k_nope, k_rope.to(k_nope.dtype).expand(*k_nope.shape[:3], m.rope_head_dim)],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    # the full-sequence path admits the blocked impl (asymmetric dv)
    impl = cfg.attn_impl if (q_pos is None and k_valid_len is None) else "ref"
    out = _sdpa(q, k, v, causal=True, q_pos=q_pos, k_valid_len=k_valid_len, impl=impl)
    return out.reshape(b, s, h * m.v_head_dim) @ p["wo"].to(q_nope.dtype)


def mla_forward(cfg, p, x, positions, *, cache=None, cache_pos=None):
    """MLA attention; the cache holds the compressed latent and the rope
    key, {c_kv: (B, Smax, r), k_rope: (B, Smax, 1, rd)}, written in place
    at ``cache_pos`` (an int, or a (B,) tensor of per-slot offsets).
    Returns (out, cache)."""
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(cfg, p, x, positions)
    if cache is None:
        return _mla_attend(cfg, p, q_nope, q_rope, c_kv, k_rope), None
    s = x.shape[1]
    if torch.is_tensor(cache_pos) and cache_pos.dim() != 0:
        # per-slot positions (continuous batching): see gqa_forward
        cc = _update_slots(cache["c_kv"], c_kv, cache_pos)
        cr = _update_slots(cache["k_rope"], k_rope, cache_pos)
        out = _mla_attend(cfg, p, q_nope, q_rope, cc, cr,
                          q_pos=positions, k_valid_len=(cache_pos + s)[:, None, None])
        return out, cache
    pos0 = int(cache_pos)
    smax = cache["c_kv"].shape[1]
    pos = min(max(pos0, 0), smax - s)   # dynamic_update_slice clamps the offset
    cc, cr = cache["c_kv"], cache["k_rope"]
    write_rows(cc, c_kv, pos)
    write_rows(cr, k_rope, pos)
    if s == smax:
        # full-capacity prefill (static condition): attend over the fresh
        # latents, which is equivalent and admits the blocked impl
        out = _mla_attend(cfg, p, q_nope, q_rope, c_kv, k_rope)
    else:
        out = _mla_attend(cfg, p, q_nope, q_rope, cc, cr,
                          q_pos=positions if positions.dim() else positions[None],
                          k_valid_len=pos0 + s)
    return out, cache


def init_mla_cache(cfg, batch: int, max_len: int, dtype, device) -> dict:
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_len, 1, m.rope_head_dim), dtype=dtype, device=device),
    }


# --------------------------------------------------------------- cross-attn
def init_cross_attention(gen, cfg, dtype, stack=()) -> dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    s, ax = tuple(stack), len(stack)
    return {
        "wq": dense_init(gen, (*s, d, h * hd), ax, dtype=dtype),
        "wk": dense_init(gen, (*s, d, h * hd), ax, dtype=dtype),
        "wv": dense_init(gen, (*s, d, h * hd), ax, dtype=dtype),
        "wo": dense_init(gen, (*s, h * hd, d), ax, dtype=dtype),
    }


def cross_attention(cfg, p, x, enc_kv=None, enc_out=None):
    """Decoder-to-encoder attention, always the plain ``ref`` impl. Pass
    the cached ``enc_kv`` at decode time or ``enc_out`` to compute K/V."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    q = _heads(x @ p["wq"].to(x.dtype), h, hd)
    if enc_kv is None:
        k = _heads(enc_out @ p["wk"].to(x.dtype), h, hd)
        v = _heads(enc_out @ p["wv"].to(x.dtype), h, hd)
    else:
        k, v = enc_kv["k"].to(x.dtype), enc_kv["v"].to(x.dtype)
    out = _sdpa(q, k, v, causal=False, impl="ref")
    return out.reshape(b, s, h * hd) @ p["wo"].to(x.dtype)


def make_cross_kv(cfg, p, enc_out):
    b = enc_out.shape[0]
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    k = _heads(enc_out @ p["wk"].to(enc_out.dtype), h, hd)
    v = _heads(enc_out @ p["wv"].to(enc_out.dtype), h, hd)
    return {"k": k, "v": v}
