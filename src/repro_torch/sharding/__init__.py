from .specs import (
    P,
    batch_axes,
    batch_spec,
    cache_specs,
    fsdp_axes,
    mesh_axis_sizes,
    param_specs,
    to_placements,
)

__all__ = [
    "P",
    "param_specs",
    "cache_specs",
    "batch_spec",
    "batch_axes",
    "fsdp_axes",
    "mesh_axis_sizes",
    "to_placements",
]
