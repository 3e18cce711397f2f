"""Carry the reference's weights across.

The port keeps the reference's parameter tree: the same keys, the stacked
leading ``n_layers`` axis, and the ``(d_in, d_out)`` layout of every
matrix. So a conversion is a leaf-by-leaf copy into tensors, and both
packages then compute with the same weights.
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
    return {k: params_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}
