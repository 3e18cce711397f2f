"""pixtral-12b [hf:mistralai/Pixtral-12B-2409]: 40L mistral-nemo backbone,
d=5120, 32H GQA kv=8 (head_dim=128), ff=14336.

The pixtral ViT is a STUB: input_specs() provides 256 precomputed patch
embeddings (dim 1024) per sample; a trainable adapter projects to d_model and
the patches are prepended to the token stream (labels ignored there).
"""

from .base import ModelConfig

config = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=131072,
    head_dim=128,
    frontend="vision",
    frontend_dim=1024,
    vision_tokens=256,
    grad_accum=16,
    fsdp_pod=True,
    attn_impl="blocked",
)
