"""The one rule for where the port's entry points run.

``"cuda"`` (the default everywhere) runs the hand-written kernels on the
card; ``"cpu"`` runs the same torch chain with each kernel's plain version
on CPU tensors. A request for the card on a machine without one raises: the
port never moves work to the CPU on its own.
"""

from __future__ import annotations

import torch


def torch_device(device) -> torch.device:
    """Validate ``device`` ("cuda", "cuda:N" or "cpu") and return it."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch sees no CUDA device; "
            "pass device='cpu' to run the plain versions on the CPU")
    return dev
