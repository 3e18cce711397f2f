"""Wrapper of the flash-attention CUDA kernel (``csrc/flash_attention.cu``).

The wrapper checks device, dtype, shape and layout, allocates the output
with ``torch.empty``, launches on the current stream, raises on a CUDA
error, and counts its launches in a plain integer attribute
(``flash_attention.launches``, bumped under a lock by ``_build.bump``). The plain version is
:func:`.ref.attention_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: float | None = None) -> torch.Tensor:
    """Blocked online-softmax attention on the card.

    ``q``: (B, Hq, Sq, D); ``k``, ``v``: (B, Hkv, Sk, D), Hq a multiple of
    Hkv (query head ``h`` reads kv head ``h // (Hq/Hkv)``). Any strides
    with a contiguous head dim, so a (B, S, H, D) tensor's transposed view
    goes in without a copy. float32 or bf16, D in 32, 64, 128. Returns a
    contiguous (B, Hq, Sq, D) tensor in q's dtype.
    """
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
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=dev)
    lib = _build.load("flash_attention")
    fn = lib.fa_forward
    fn.argtypes = [_P, _P, _P, _P] + [ctypes.c_int] * 7 + [_LL] * 12 + [
        ctypes.c_float, ctypes.c_int, _P]
    fn.restype = ctypes.c_int
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
             d, b, hq, hkv, sq, sk, *strides, float(sm_scale), int(bool(causal)),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "fa", err, "flash_attention launch")
    _build.bump(flash_attention)
    return out


flash_attention.launches = 0
