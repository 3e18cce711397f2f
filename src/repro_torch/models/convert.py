"""Carry the reference's weights across.

The port keeps the reference's parameter tree: the same keys, the stacked
leading ``n_layers`` axis, and the ``(d_in, d_out)`` layout of every
matrix. So a conversion is a leaf-by-leaf copy into tensors, and both
packages then compute with the same weights.

Every walk over a tree takes its leaves in ``jax.tree_util``'s order: dict
keys sorted at every level. A leaf's path is its keys joined by ``/``. The
checkpoint's leaf keys, the gradient tree and the optimizer's leaf loops
all rest on the helpers here.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import torch_device


def _leaf(a, dev: torch.device) -> torch.Tensor:
    a = np.array(a)   # a writable copy: torch.from_numpy shares memory
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def params_from_jax(tree: dict, device="cuda") -> dict:
    """The port's parameters from the reference's parameter dict with numpy
    leaves (``jax.device_get(model.init(key))``), on ``device``."""
    dev = torch_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return _leaf(t, dev)

    return conv(tree)


def params_to(tree: dict, device) -> dict:
    """A parameter tree (nested dicts of tensors) copied to ``device``."""
    return tree_map(lambda t: t.to(device), tree)


SEP = "/"


def flatten_with_paths(tree, upto=None) -> list[tuple[str, object]]:
    """``(path, leaf)`` pairs of a nested dict, in sorted-key order. With
    ``upto`` (a tree whose structure is a prefix of ``tree``'s), the walk
    stops at ``upto``'s leaves and pairs each with the subtree of ``tree``
    there."""
    shape = tree if upto is None else upto
    if not isinstance(shape, dict):
        return [("", tree)]
    return [(f"{k}{SEP}{path}" if path else k, leaf) for k in sorted(shape)
            for path, leaf in flatten_with_paths(tree[k], shape[k])]


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in ``jax.tree.leaves`` order."""
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(pairs) -> dict:
    """The nested dict of ``(path, leaf)`` pairs."""
    root: dict = {}
    for key, leaf in pairs:
        *parents, last = key.split(SEP)
        node = root
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return root


def unflatten_like(tree, leaves) -> dict:
    """A tree with ``tree``'s structure over ``leaves`` (in its leaf order)."""
    return unflatten(zip((k for k, _ in flatten_with_paths(tree)), leaves))


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of trees with its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)
