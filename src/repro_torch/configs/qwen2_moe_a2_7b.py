"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]: 24L, d=2048, 16H, MoE with
60 routed experts top-4 (ff=1408) + 4 shared experts.

Experts are padded 60 -> 64 for EP divisibility over the 16-way model axis
(padding experts get -inf router logits; DESIGN.md §6).
"""

from .base import ModelConfig, MoEConfig

config = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    moe=MoEConfig(
        n_experts=60, top_k=4, d_expert=1408, n_shared=4,
        pad_experts_to=64, capacity_factor=1.25,
    ),
    grad_accum=16,
    attn_impl="blocked",
    moe_grouped=True,
)
