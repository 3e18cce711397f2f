"""zamba2-1.2b [arXiv:2411.15242]: 38 Mamba2 layers (d=2048, state=64) + ONE
weight-shared attention block (32H, ff=8192) applied every 6th layer with
per-site KV caches. Hybrid => sub-quadratic => runs long_500k; the shared
block's KV cache is sequence-sharded (SP) at long context.
"""

from .base import ModelConfig, SSMConfig

config = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    head_dim=64,
    ssm=SSMConfig(d_state=64, headdim=64, expand=2, conv_width=4, chunk=64),
    hybrid_attn_every=6,
    sub_quadratic=True,
    seq_shard_cache=True,
    grad_accum=8,
    attn_impl="blocked",
    ssd_matmul_dtype="bfloat16",
)
