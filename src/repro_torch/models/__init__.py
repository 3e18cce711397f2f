"""The LM stack: dense decoder family (GQA attention + SwiGLU), its KV
caches, and conversion of the reference's weights."""

from .convert import params_from_jax
from .model import Model, build_model

__all__ = ["Model", "build_model", "params_from_jax"]
