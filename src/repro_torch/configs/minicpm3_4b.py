"""minicpm3-4b [hf:openbmb/MiniCPM3-4B]: 62L, d=2560, 40H, ff=6400, MLA.

MLA dims from the HF config: q_lora_rank=768, kv_lora_rank=256,
qk_rope_head_dim=32, qk_nope_head_dim=64, v_head_dim=64. The decode cache
stores the 256-d compressed latent + 32-d rope key (MLA's tiny-KV property).
"""

from .base import MLAConfig, ModelConfig

config = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab=73448,
    mla=MLAConfig(
        q_lora_rank=768, kv_lora_rank=256,
        rope_head_dim=32, nope_head_dim=64, v_head_dim=64,
    ),
    grad_accum=16,
    attn_impl="blocked",
)
