"""Device meshes (``repro/launch/mesh.py``) over ``torch.distributed``.

Every mesh constructor here is a FUNCTION: importing this module touches no process
group and no device. A mesh needs the default process group initialised
first (``torchrun``, a ``FileStore``, or the dry run's fake group).

Single pod: 16x16 = 256 ranks, axes (data, model). Multi-pod: 2x16x16 =
512 ranks, axes (pod, data, model): 'pod' carries cross-pod DP (or FSDP for
the pod-FSDP configs); 'data' carries in-pod DP/FSDP; 'model' carries
TP/EP. These are the deployment the reference's configs name.

:class:`MeshShape` is a stand-in with only the axis names and sizes: the
partition rules (:mod:`repro_torch.sharding.specs`) read nothing else, so
tests and the dry run's bookkeeping use it without a process group.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class MeshShape:
    axis_names: tuple[str, ...]
    shape: tuple[int, ...]

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def production_shape(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def default_device_type() -> str:
    """The device type of a mesh over the default group: ``cuda`` for
    NCCL, ``cpu`` for gloo and the fake group."""
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mk_mesh(shape: MeshShape, device_type: str | None):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type or default_device_type(), shape.shape,
                            mesh_dim_names=shape.axis_names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """The (16, 16) or (2, 16, 16) mesh over a default group of 256 or 512 ranks."""
    return _mk_mesh(production_shape(multi_pod=multi_pod), device_type)


def make_host_mesh(data: int = 1, model: int = 1, device_type: str | None = None):
    """A small (data, model) mesh over the default group. Where the group
    has fewer ranks than ``data * model`` the mesh is clamped to
    ``(world, 1)``, as the reference clamps to the devices it finds."""
    import torch.distributed as dist

    n = dist.get_world_size()
    if data * model > n:
        data, model = n, 1
    return _mk_mesh(MeshShape(("data", "model"), (data, model)), device_type)
