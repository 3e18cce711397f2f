"""qwen3-8b [hf:Qwen/Qwen3-8B]: 36L, d=4096, 32H GQA kv=8, ff=12288, qk-norm."""

from .base import ModelConfig

config = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12288,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    grad_accum=16,
    attn_impl="blocked",
)
