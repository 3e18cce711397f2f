"""Wrappers of the two flash-attention CUDA kernels.

- bf16 goes to :func:`flash_attention_sm90` (``csrc/flash_attention_sm90.cu``:
  ``wgmma`` on the tensor cores, fed by TMA through a ring of K/V tiles);
- float32 goes to :func:`flash_attention_f32` (``csrc/flash_attention.cu``:
  split TF32 on the tensor cores, ``mma.sync`` fed by ``cp.async``: each
  operand is split into two TF32 parts and each product formed in three
  passes, float32-accurate to the 1e-5 yardstick).

:func:`flash_attention` picks the route by dtype; there is no fallback
from one kernel to the other. Each wrapper checks its arguments, allocates
the output with ``torch.empty``, launches on the current stream, raises on
a CUDA error, and counts its launches in a plain integer attribute
(``flash_attention_sm90.launches``, ``flash_attention_f32.launches``,
bumped under a lock by ``_build.bump``). The plain version is
:func:`.ref.attention_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
HEAD_DIMS = (32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)


def _shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Check what both kernels take; returns (B, Hq, Hkv, Sq, Sk, D)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("flash_attention kernel needs CUDA tensors")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-D (B, H, S, D)")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, sk, d) or v.shape != k.shape:
        raise ValueError(f"k and v must be (B, Hkv, Sk, D) = {(b, hkv, sk, d)}, "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported; the kernel takes {HEAD_DIMS}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for t, name in ((k, "k"), (v, "v")):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype}, got {t.dtype}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have a contiguous head dim")
    if b * hq > 65535:
        raise ValueError(f"B*Hq = {b * hq} exceeds the grid's 65535")
    return b, hq, hkv, sq, sk, d


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: float | None = None) -> torch.Tensor:
    """Blocked online-softmax attention on the card.

    ``q``: (B, Hq, Sq, D); ``k``, ``v``: (B, Hkv, Sk, D), Hq a multiple of
    Hkv (query head ``h`` reads kv head ``h // (Hq/Hkv)``). Any strides
    with a contiguous head dim, so a (B, S, H, D) tensor's transposed view
    goes in without a copy. float32 or bf16, D in 32, 64, 128. Returns a
    contiguous (B, Hq, Sq, D) tensor in q's dtype. bf16 launches the
    ``wgmma`` kernel, float32 the split-TF32 kernel.
    """
    fn = flash_attention_sm90 if q.dtype == torch.bfloat16 else flash_attention_f32
    return fn(q, k, v, causal=causal, sm_scale=sm_scale)


def flash_attention_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, sm_scale: float | None = None) -> torch.Tensor:
    """The split-TF32 kernel (``csrc/flash_attention.cu``), float32 only.

    Its 128-row query tiles start where the reference's front-padded blocks
    start, so with Sk % 128 == 0 a causal row that sees no key comes out 0,
    as through the TPU kernel. 16-byte copies where every base and stepped
    stride allows them, 4-byte copies otherwise."""
    b, hq, hkv, sq, sk, d = _shapes(q, k, v)
    if q.dtype != torch.float32:
        raise TypeError(f"the split-TF32 kernel takes float32, got {q.dtype}")
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    fn = _build.entry("flash_attention", "fa_forward", [_P, _P, _P, _P] + [ctypes.c_int] * 6
                      + [_LL] * 12 + [ctypes.c_float, ctypes.c_int, _P])
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), d, b, hq, hkv, sq, sk,
             *strides, float(sm_scale), int(bool(causal)),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(_build.load("flash_attention"), "fa", err, "flash_attention launch")
    _build.bump(flash_attention_f32)
    return out


def flash_attention_sm90(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, sm_scale: float | None = None) -> torch.Tensor:
    """The Hopper kernel (``csrc/flash_attention_sm90.cu``), bf16 only.

    TMA reads q, k and v through tensor maps, so each base must be 16-byte
    aligned and each batch, head and row stride a multiple of 8 elements
    (any stride of a dimension of extent 1 is ignored).
    """
    b, hq, hkv, sq, sk, d = _shapes(q, k, v)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the sm90 kernel takes bfloat16, got {q.dtype}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary for TMA")
        if any(t.stride(i) % 8 for i in range(3) if t.shape[i] > 1):
            raise ValueError(f"{name}'s batch, head and row strides {t.stride()[:3]} "
                             "must be multiples of 8 elements for TMA")
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    fn = _build.entry("flash_attention_sm90", "fa90_forward", [_P, _P, _P, _P]
                      + [ctypes.c_int] * 6 + [_LL] * 9 + [ctypes.c_float, ctypes.c_int, _P])
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), d, b, hq, hkv, sq, sk,
             *strides, float(sm_scale), int(bool(causal)),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(_build.load("flash_attention_sm90"), "fa90", err,
                 "flash_attention_sm90 launch")
    _build.bump(flash_attention_sm90)
    return out


flash_attention_f32.launches = 0
flash_attention_sm90.launches = 0
