"""The LM stack: every family of the reference (dense, MoE, SSM, hybrid,
encoder-decoder, vision-language) with GQA, MLA and cross-attention, their
caches, the loss, and conversion of the reference's weights."""

from .convert import (flatten_with_paths, params_from_jax, params_to, tree_leaves,
                      tree_map, unflatten, unflatten_like)
from .model import Model, build_model, flash_calls

__all__ = ["Model", "build_model", "flash_calls", "flatten_with_paths", "params_from_jax",
           "params_to", "tree_leaves", "tree_map", "unflatten", "unflatten_like"]
