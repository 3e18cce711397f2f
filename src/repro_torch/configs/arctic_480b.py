"""arctic-480b [hf:Snowflake/snowflake-arctic-base]: 35L, d=7168, 56H GQA
kv=8, MoE 128 experts top-2 (expert ff=4864) + parallel dense FFN residual.

At 480B params this is the memory-limit config: bf16 params + bf16 Adam
moments, FSDP extended over the pod axis, grad-accum 8.
"""

from .base import ModelConfig, MoEConfig

config = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab=32000,
    head_dim=128,
    moe=MoEConfig(
        n_experts=128, top_k=2, d_expert=4864,
        dense_ff_parallel=4864, capacity_factor=1.25,
    ),
    param_dtype="bfloat16",
    opt_state_dtype="bfloat16",
    fsdp_pod=True,
    grad_accum=8,
    attn_impl="blocked",
    moe_grouped=True,
)
