"""spatial-lm: the paper's own end-to-end arch — a small Mamba2 trajectory LM
trained on geo-token streams decoded from Spatial Parquet data lakes
(examples/train_trajectory_lm.py). Not part of the assigned 10."""

from .base import ModelConfig, SSMConfig

config = ModelConfig(
    name="spatial-lm",
    family="ssm",
    n_layers=12,
    d_model=512,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=4096,
    ssm=SSMConfig(d_state=64, headdim=32, expand=2, conv_width=4, chunk=128),
    tie_embeddings=True,
    sub_quadratic=True,
    dtype="float32",
    param_dtype="float32",
    remat="none",
)
