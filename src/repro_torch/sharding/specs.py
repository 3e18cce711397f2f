"""Partition rules (``repro/sharding/specs.py``): DP/FSDP over 'data' (+'pod'),
TP over 'model', EP for MoE experts, SP (sequence sharding) for
long-context decode caches.

Rules are path-keyed over the parameter tree and specify specs for the
*trailing* dims of each leaf; leading dims (the stacked ``n_layers`` /
``n_sites`` axes) are padded with None. Any dim whose size does not divide
its mesh axis falls back to replication (logged by the dry run, not silent).

The rules read only a mesh's axis names and sizes, so they take a
``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh` or
the light :class:`repro_torch.launch.mesh.MeshShape` alike. A spec is a
:class:`P`, one mesh axis name (or a tuple of names, or ``None``) per dim,
printed as ``jax.sharding.PartitionSpec`` prints. :func:`to_placements`
turns a tree of specs into DTensor placements, one per mesh dim.
"""

from __future__ import annotations

from ..configs.base import ModelConfig
from ..models.convert import flatten_with_paths, unflatten_like


class P(tuple):
    """A partition spec: the mesh axis (a name, a tuple of names, or None)
    of each dim. A one-name tuple is that name, as ``PartitionSpec`` holds
    it."""

    def __new__(cls, *axes):
        return super().__new__(cls, (a[0] if isinstance(a, tuple) and len(a) == 1 else a
                                     for a in axes))

    def __repr__(self) -> str:
        return f"PartitionSpec({', '.join(repr(a) for a in self)})"


def mesh_axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "axis_names", None)
    return tuple(names if names is not None else mesh.mesh_dim_names)


def mesh_axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh_axis_names(mesh), tuple(mesh.shape)))


def fsdp_axes(cfg: ModelConfig, mesh):
    axes = tuple(a for a in ("pod", "data") if a in mesh_axis_names(mesh))
    if not cfg.fsdp_pod:
        axes = tuple(a for a in axes if a != "pod")
    return axes if axes else None


def batch_axes(mesh):
    axes = tuple(a for a in ("pod", "data") if a in mesh_axis_names(mesh))
    return axes if axes else None


def _axis_size(mesh, axis) -> int:
    sizes = mesh_axis_sizes(mesh)
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= sizes[a]
        return n
    return sizes[axis]


class SpecBuilder:
    def __init__(self, cfg: ModelConfig, mesh):
        self.cfg = cfg
        self.mesh = mesh
        self.fsdp = fsdp_axes(cfg, mesh)
        self.tp = "model" if "model" in mesh_axis_names(mesh) else None
        self.fallbacks: list[str] = []

    def dim(self, size: int, axis, what: str = ""):
        """Use ``axis`` for a dim only if the size divides the axis product."""
        if axis is None:
            return None
        if size % _axis_size(self.mesh, axis) != 0:
            self.fallbacks.append(f"{what}: dim {size} !% axis {axis} -> replicated")
            return None
        return axis

    def spec(self, shape: tuple[int, ...], *axes, what: str = "") -> P:
        if len(axes) != len(shape):
            raise ValueError(f"spec of {len(axes)} axes for shape {shape}")
        return P(*[self.dim(s, a, what) for s, a in zip(shape, axes)])


def _leaf_spec(b: SpecBuilder, path: str, shape: tuple[int, ...]) -> P:
    """Spec for the trailing dims of a parameter leaf (path '/'-joined)."""
    name = path.split("/")[-1]
    fsdp, tp = b.fsdp, b.tp

    def pad(spec_dims: list, ndim: int) -> P:
        lead = [None] * (ndim - len(spec_dims))
        return P(*lead, *spec_dims)

    nd = len(shape)

    # ---- scalars / vectors: replicated
    if name in ("ln1", "ln2", "ln_cross", "final_norm", "norm", "q_norm",
                "k_norm", "kv_norm", "dt_bias", "A_log", "D"):
        return P(*[None] * nd)
    # ---- embeddings / head
    if name == "embed":
        return pad([b.dim(shape[-2], tp, name), b.dim(shape[-1], fsdp, name)], nd)
    if name == "lm_head":
        return pad([b.dim(shape[-2], fsdp, name), b.dim(shape[-1], tp, name)], nd)
    if name == "frontend_adapter":
        return pad([None, b.dim(shape[-1], tp, name)], nd)
    # ---- MoE expert stacks (trailing dims: E, in, out); shared/dense expert
    #      MLPs (paths .../moe/shared/*, .../moe/dense/*) use plain MLP rules.
    if "moe" in path and "shared" not in path and "dense" not in path:
        if name == "router":
            return pad([b.dim(shape[-2], fsdp, name), None], nd)
        if name in ("w_gate", "w_up") and nd >= 3:
            return pad([b.dim(shape[-3], tp, "EP"), b.dim(shape[-2], fsdp, name), None], nd)
        if name == "w_down" and nd >= 3:
            return pad([b.dim(shape[-3], tp, "EP"), None, b.dim(shape[-1], fsdp, name)], nd)
    # ---- MLA
    if name in ("wq_a", "wkv_a"):
        return pad([b.dim(shape[-2], fsdp, name), None], nd)
    if name in ("wq_b", "wkv_b"):
        return pad([None, b.dim(shape[-1], tp, name)], nd)
    # ---- SSM
    if name in ("wz", "wx"):
        return pad([b.dim(shape[-2], fsdp, name), b.dim(shape[-1], tp, name)], nd)
    if name in ("wB", "wC", "wdt"):
        return pad([b.dim(shape[-2], fsdp, name), None], nd)
    if name == "conv_x":
        return pad([None, b.dim(shape[-1], tp, name)], nd)
    if name in ("conv_B", "conv_C"):
        return P(*[None] * nd)
    if name == "out_proj":
        return pad([b.dim(shape[-2], tp, name), b.dim(shape[-1], fsdp, name)], nd)
    # ---- attention / MLP matrices
    if name in ("wq", "wk", "wv", "w_gate", "w_up"):
        return pad([b.dim(shape[-2], fsdp, name), b.dim(shape[-1], tp, name)], nd)
    if name in ("wo", "w_down"):
        return pad([b.dim(shape[-2], tp, name), b.dim(shape[-1], fsdp, name)], nd)
    return P(*[None] * nd)


def param_specs(cfg: ModelConfig, mesh, params_shape) -> tuple:
    """(tree of :class:`P` matching params, list of fallback notes).

    ``params_shape`` is a tree of anything with a ``.shape`` (tensors on
    the ``meta`` device, fake tensors, real ones)."""
    b = SpecBuilder(cfg, mesh)
    specs = [_leaf_spec(b, path, tuple(leaf.shape))
             for path, leaf in flatten_with_paths(params_shape)]
    return unflatten_like(params_shape, specs), b.fallbacks


def batch_spec(cfg: ModelConfig, mesh, *, microbatched: bool) -> P:
    """Sharding for (.., B, S)-shaped token arrays (leading accum dim unsharded)."""
    dp = batch_axes(mesh)
    return P(None, dp) if microbatched else P(dp)


def cache_specs(cfg: ModelConfig, mesh, cache_shape) -> tuple:
    """Specs for the serving cache tree.

    Layer K/V caches (L, B, S, H, D): batch over dp; heads over tp; if
    ``cfg.seq_shard_cache`` and the batch cannot shard (B=1 long-context),
    the sequence dim shards over 'data' instead (SP decode).
    """
    b = SpecBuilder(cfg, mesh)
    dp = batch_axes(mesh)
    data_only = "data" if "data" in mesh_axis_names(mesh) else None

    def visit(keys, shape):
        nd = len(shape)
        if keys.endswith("pos"):
            return P()
        batch_dim_ok = shape[1] % _axis_size(b.mesh, dp) == 0 if nd >= 2 and dp else False
        if "cross" in keys or keys.endswith("k") or keys.endswith("v"):
            # (L, B, S, H, hd) attention caches (layer or site stacked)
            if nd == 5:
                heads_ax = b.dim(shape[3], b.tp, keys)
                if batch_dim_ok:
                    if heads_ax is None:
                        # heads !% tp (MQA/GQA few-head caches): SP over the
                        # model axis on the sequence dim instead — the
                        # attention contraction psums across 'model'
                        return P(None, dp, b.dim(shape[2], b.tp, keys), None, None)
                    return P(None, dp, None, heads_ax, None)
                if cfg.seq_shard_cache:
                    return P(None, None, b.dim(shape[2], data_only, keys),
                             heads_ax, None)
                return P(None, None, None, heads_ax, None)
        if keys.endswith("c_kv"):       # (L, B, S, r) MLA latent: SP on seq
            return P(None, dp if batch_dim_ok else None,
                     b.dim(shape[2], b.tp, keys), None)
        if keys.endswith("k_rope"):     # (L, B, S, 1, rd)
            return P(None, dp if batch_dim_ok else None,
                     b.dim(shape[2], b.tp, keys), None, None)
        if keys.endswith("state"):      # (L, B, H, N, P) ssm state
            return P(None, dp if batch_dim_ok else None,
                     b.dim(shape[2], b.tp, keys), None, None)
        if "conv" in keys:              # (L, B, w-1, C)
            return P(None, dp if batch_dim_ok else None, None,
                     b.dim(shape[3], b.tp, keys))
        return P(*[None] * nd)

    specs = [visit(path, tuple(leaf.shape)) for path, leaf in flatten_with_paths(cache_shape)]
    return unflatten_like(cache_shape, specs), b.fallbacks


def placements(mesh, spec: P, ndim: int | None = None) -> tuple:
    """DTensor placements of one spec: for each mesh dim, ``Shard(d)`` for
    the tensor dim ``d`` whose spec names that mesh axis (alone or in a
    tuple), else ``Replicate()``. A mesh axis of size 1 shards nothing and
    stays ``Replicate()``: the same layout, and one that every DTensor
    version can reshape (torch 2.11 refuses to flatten a dim sharded over
    it). A spec shorter than ``ndim`` is padded with None at the end, as
    ``PartitionSpec`` is."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axis_names(mesh)
    sizes = mesh_axis_sizes(mesh)
    out: list = [Replicate()] * len(names)
    for d, axis in enumerate(spec):
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            if a is None or sizes[a] == 1:
                continue
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {a!r} shards two dims in {spec!r}")
            out[i] = Shard(d)
    if ndim is not None and len(spec) > ndim:
        raise ValueError(f"spec {spec!r} has more dims than {ndim}")
    return tuple(out)


def to_placements(mesh, spec_tree):
    """A tree of DTensor placements (one tuple per leaf) for a tree of specs."""
    return unflatten_like(spec_tree, [placements(mesh, s)
                                      for _, s in flatten_with_paths(spec_tree)])
