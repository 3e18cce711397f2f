"""mamba2-130m [arXiv:2405.21060]: 24L pure SSD, d=768, state=128, attn-free.

sub-quadratic => runs long_500k (O(1)-state decode)."""

from .base import ModelConfig, SSMConfig

config = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(d_state=128, headdim=64, expand=2, conv_width=4, chunk=64),
    tie_embeddings=True,
    sub_quadratic=True,
    grad_accum=8,
    ssd_matmul_dtype="bfloat16",
)
