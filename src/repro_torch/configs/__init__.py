"""Architecture registry: ``get_config(arch_id)`` for every assigned arch.

Sources are cited per file; exact dims follow the assignment table.
"""

from __future__ import annotations

from .base import SHAPES, MLAConfig, ModelConfig, MoEConfig, ShapeConfig, SSMConfig, shape_applicable
from .arctic_480b import config as _arctic
from .granite_20b import config as _granite
from .internlm2_1_8b import config as _internlm2
from .mamba2_130m import config as _mamba2
from .minicpm3_4b import config as _minicpm3
from .pixtral_12b import config as _pixtral
from .qwen2_moe_a2_7b import config as _qwen2moe
from .qwen3_8b import config as _qwen3
from .spatial_lm import config as _spatial_lm
from .whisper_medium import config as _whisper
from .zamba2_1_2b import config as _zamba2

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        _whisper,
        _minicpm3,
        _granite,
        _qwen3,
        _internlm2,
        _zamba2,
        _arctic,
        _qwen2moe,
        _mamba2,
        _pixtral,
        _spatial_lm,
    )
}

ASSIGNED = [n for n in ARCHS if n != "spatial-lm"]


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = [
    "ARCHS",
    "ASSIGNED",
    "SHAPES",
    "get_config",
    "ModelConfig",
    "MoEConfig",
    "MLAConfig",
    "SSMConfig",
    "ShapeConfig",
    "shape_applicable",
]
