"""whisper-medium [arXiv:2212.04356]: enc-dec, 24+24L, d=1024, 16H, ff=4096.

Conv frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings (B, S/2, 1024) — Whisper's stride-2 conv stack
gives 2x temporal downsampling. Decoder uses RoPE (simplification of learned
positions; noted in DESIGN.md).
"""

from .base import ModelConfig

config = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    frontend="audio",
    frontend_dim=1024,
    frontend_downsample=2,
    sub_quadratic=False,
    has_decoder=True,
    grad_accum=8,
    attn_impl="blocked",
)
