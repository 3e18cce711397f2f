"""granite-20b-code [arXiv:2405.04324]: 52L, d=6144, 48H MQA (kv=1), ff=24576."""

from .base import ModelConfig

config = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    head_dim=128,
    grad_accum=16,
    fsdp_pod=True,
    attn_impl="blocked",
)
