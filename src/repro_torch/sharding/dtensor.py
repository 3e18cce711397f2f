"""The model's few explicit redistributes on a mesh.

The port's model code runs on plain tensors or, under a mesh, on DTensors
whose sharding propagates op by op (under ``implicit_replication``, so the
tensors an op makes inside, such as positions and masks, count as
replicated). Where an op has no sharding rule, or where the reference
steers its partitioner with a constraint, the model calls one of these.
Each is the identity on a plain tensor, so a run without a mesh takes the
same path as before. Beside them: the placement helpers the step factories
use (:func:`axes_placements`, :func:`shard_tensor`, :func:`full`) and
:func:`mesh_scope`, the context the model runs in on a mesh.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map_only, tree_unflatten


BATCH_AXES = ("pod", "data")   # the mesh axes a batch shards over, where present


def is_dtensor(t) -> bool:
    return isinstance(t, DTensor)


def replicate_dim(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` whole along ``dim``: every ``Shard(dim)`` placement made
    ``Replicate()`` (an all-gather over those mesh axes) and every pending
    partial sum reduced (an all-reduce). Other shardings stay."""
    if not isinstance(t, DTensor):
        return t
    dim %= t.ndim
    pl = tuple(Replicate() if (isinstance(p, Shard) and p.dim == dim) or p.is_partial() else p
               for p in t.placements)
    return t if pl == tuple(t.placements) else t.redistribute(t.device_mesh, pl)


def axes_placements(mesh, shape, axes) -> tuple:
    """Placements that shard dim ``d`` over the mesh axis (or axes)
    ``axes[d]``: names the mesh lacks and axes of size 1 are skipped (as in
    :func:`repro_torch.sharding.specs.placements`), and a dim that does not
    divide its axes stays whole."""
    names = mesh.mesh_dim_names
    pl = [Replicate()] * mesh.ndim
    for d, a in enumerate(axes):
        group = [n for n in (a if isinstance(a, tuple) else (a,))
                 if n is not None and n in names and mesh.size(names.index(n)) > 1]
        ways = 1
        for n in group:
            ways *= mesh.size(names.index(n))
        if group and shape[d] % ways == 0:
            for n in group:
                pl[names.index(n)] = Shard(d)
    return tuple(pl)


def local_call(fn, args: tuple, axes: tuple, out_axes, out_shape):
    """``fn(*args)`` on each rank's own blocks.

    Without a mesh, the plain call. On a mesh, each argument is
    redistributed (explicitly) to its ``axes`` (one entry per dim, as
    :func:`axes_placements` reads them), ``fn`` runs on the local tensors
    (``local_map``: the ops inside need no sharding rule) and its output,
    of global shape ``out_shape``, comes back sharded by ``out_axes``; for
    several outputs both are lists, one entry per output. Plain tensor
    arguments count as replicated, and ``None`` arguments pass through. The
    backward sums the gradient of an argument that is whole over a mesh dim
    that splits the work (a partial sum over that dim). Over every mesh dim
    but the batch axes that sum is made at once, so each argument's
    gradient leaves with the placements the argument came with: left
    pending, a partial sum can reach an op that DTensor resolves by
    scattering it over another dim, such as the sequence. Over the batch
    axes a weight's partial sums stay pending until the step reduces them."""
    dts = [a for a in args if isinstance(a, DTensor)]
    if not dts:
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    mesh = dts[0].device_mesh
    args = tuple(a if a is None or isinstance(a, DTensor)
                 else DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
                 for a in args)
    names = mesh.mesh_dim_names
    args = tuple(a if a is None or not a.requires_grad else
                 _Placed.apply(a, a.placements, tuple(None if names[i] in BATCH_AXES else p
                                                      for i, p in enumerate(a.placements)))
                 for a in args)
    in_pl = tuple(None if a is None else axes_placements(mesh, a.shape, ax)
                  for a, ax in zip(args, axes))
    several = isinstance(out_shape, list)
    out_pl = [axes_placements(mesh, sh, ax) for sh, ax in
              (zip(out_shape, out_axes) if several else [(out_shape, out_axes)])]
    # an argument whole over a mesh dim that splits the work gets a
    # different gradient on each rank of it: a partial sum
    split = [any(isinstance(pl[i], Shard) for pl in (*filter(None, in_pl), *out_pl))
             for i in range(mesh.ndim)]
    grad_pl = tuple(None if pl is None else
                    tuple(Partial() if split[i] and isinstance(p, Replicate) else p
                          for i, p in enumerate(pl)) for pl in in_pl)
    # one output's placements go as a list (a tuple would read as one per output)
    out = tuple(out_pl) if several else list(out_pl[0])
    # the work is whole where an output cannot split as asked (an argument
    # gathered whole, such as kv heads, still feeds split work)
    whole = any(_unsplit(mesh, sh, ax) for sh, ax in
                (zip(out_shape, out_axes) if several else [(out_shape, out_axes)]))

    def body(*local):
        local = [_Edge.apply(t, False) if torch.is_tensor(t) and t.requires_grad else t
                 for t in local]
        _whole.on = whole
        try:
            res = fn(*local)
        finally:
            _whole.on = False
        if not whole:
            return res
        return tree_map_only(torch.Tensor, lambda t: _Edge.apply(t, True), res)

    return local_map(body, out_placements=out, in_placements=in_pl, in_grad_placements=grad_pl,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def _unsplit(mesh, shape, axes) -> bool:
    """Whether ``axes`` asks a mesh axis (of size > 1) to split a dim of
    ``shape`` that it does not divide, so that the dim stays whole."""
    pl = axes_placements(mesh, shape, axes)
    names = mesh.mesh_dim_names
    return any(n in names and mesh.size(names.index(n)) > 1 and pl[names.index(n)] != Shard(d)
               for d, a in enumerate(axes) for n in (a if isinstance(a, tuple) else (a,)))


_whole = threading.local()    # .on: see whole_work(); per thread, as autograd's grad mode is


def whole_work() -> bool:
    """Whether the ops running now are a :func:`local_call`'s work that a
    mesh axis it asked to split could not (heads that 'model' does not
    divide, computed whole on each of its ranks): the call's forward, and
    its backward from the gradient of its output to those of its arguments
    (autograd runs a single-threaded backward in the reverse order of the
    forward). The dry run counts these FLOPs apart."""
    return getattr(_whole, "on", False)


class _Edge(torch.autograd.Function):
    """The identity at an edge of a :func:`local_call`'s body, on a rank's
    local tensor. Its backward marks whether the ops that follow are whole
    work (:func:`whole_work`: ``whole_after``), and hands the gradient on
    contiguous: ``local_map`` wraps a local gradient with the strides of the
    argument's global (contiguous) layout, and a permuted one (an einsum's
    backward hands them out) would then be viewed as if it were contiguous."""

    @staticmethod
    def forward(ctx, t, whole_after):
        ctx.whole_after = whole_after
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        _whole.on = ctx.whole_after
        return g.contiguous(), None


def split_ready(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``t`` ready to have ``dim`` split into ``n`` blocks (heads) by a
    reshape: on a mesh whose axes shard ``dim`` more ways than ``n`` splits
    evenly, ``dim`` is gathered whole first (an explicit all-gather; DTensor
    cannot split an uneven shard). Otherwise ``t`` itself."""
    if not isinstance(t, DTensor):
        return t
    dim %= t.ndim
    ways = 1
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == dim:
            ways *= t.device_mesh.size(i)
    return t if n % ways == 0 else replicate_dim(t, dim)


class _MergeReady(torch.autograd.Function):
    """The identity, whose backward makes its gradient :func:`split_ready`."""

    @staticmethod
    def forward(ctx, t, dim, n):
        ctx.dim, ctx.n = dim, n
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return split_ready(g, ctx.dim, ctx.n), None, None


def merge_ready(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``t``, whose ``dim`` was just merged from ``n`` blocks (heads) by a
    reshape, as it is; its gradient, which the backward of that reshape
    splits into ``n`` blocks again, is made :func:`split_ready` first (a
    row-parallel product hands it back sharded over 'model', which ``n``
    heads may not divide). The identity on a plain tensor."""
    if not isinstance(t, DTensor):
        return t
    return _MergeReady.apply(t, dim, n)


def gather_fsdp(tree):
    """Each DTensor leaf of a weight tree made whole over the batch axes
    ('pod', 'data'): FSDP's all-gather of a layer's weights just before
    they are used (autograd reduce-scatters their gradients back). Their
    tensor-parallel sharding over 'model' stays. Activations then keep the
    batch on the batch axes, as the reference's partitioner keeps them."""
    if isinstance(tree, dict):
        return {k: gather_fsdp(v) for k, v in tree.items()}
    if not isinstance(tree, DTensor):
        return tree
    names = tree.device_mesh.mesh_dim_names
    pl = tuple(Replicate() if names[i] in BATCH_AXES and isinstance(p, Shard) else p
               for i, p in enumerate(tree.placements))
    return tree if pl == tuple(tree.placements) else tree.redistribute(tree.device_mesh, pl)


class _Placed(torch.autograd.Function):
    """``t`` redistributed to ``pl``, and its gradient brought to
    ``grad_pl``, pending partial sums reduced, whatever placements it
    arrives in. A ``None`` entry of ``grad_pl`` leaves that mesh dim of the
    gradient as it arrives; a partial one stands for whole."""

    @staticmethod
    def forward(ctx, t, pl, grad_pl):
        ctx.grad_pl = grad_pl
        return t.redistribute(t.device_mesh, pl)

    @staticmethod
    def backward(ctx, g):
        pl = tuple(g.placements[i] if p is None else Replicate() if p.is_partial() else p
                   for i, p in enumerate(ctx.grad_pl))
        return g.redistribute(g.device_mesh, pl), None, None


def reduce_partial(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its pending partial sums or means reduced (an all-reduce),
    its gradient held whole over the same mesh dims (the gradient of a mean
    over a sharded dim comes back as a partial sum, which DTensor cannot
    turn into a partial mean). The identity on a plain tensor."""
    if not isinstance(t, DTensor) or not any(p.is_partial() for p in t.placements):
        return t
    pl = tuple(Replicate() if p.is_partial() else p for p in t.placements)
    return _Placed.apply(t, pl, pl)


def batch_sharded(t: torch.Tensor) -> torch.Tensor:
    """Activations (B, ...) with the batch on the batch axes and whole over
    every other mesh axis, pending partial sums reduced: the residual
    stream's placement between blocks, as tensor parallelism keeps it (the
    all-reduce at the end of a row-parallel product). Its gradient is held
    to the same placements (the all-reduce that tensor parallelism's
    backward makes at a block's input), so the products of the backward run
    on each rank's own share as the forward's do. The identity on a plain
    tensor."""
    if not isinstance(t, DTensor):
        return t
    pl = axes_placements(t.device_mesh, t.shape, (BATCH_AXES,) + (None,) * (t.ndim - 1))
    return _Placed.apply(t, pl, pl)


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """``t.sum()``. On a mesh each rank sums its own rows of the batch (a
    partial sum over the batch axes), so the backward hands each rank the
    gradient of its own rows only; a plain sum's backward would make that
    gradient whole on every rank, and every product behind it would then
    run on the whole batch on every rank."""
    if not isinstance(t, DTensor):
        return t.sum()
    from torch.distributed.tensor.experimental import local_map

    mesh = t.device_mesh
    pl = axes_placements(mesh, t.shape, (BATCH_AXES,) + (None,) * (t.ndim - 1))
    out = [Partial() if isinstance(p, Shard) else Replicate() for p in pl]
    return local_map(torch.sum, out_placements=out, in_placements=(pl,), device_mesh=mesh,
                     redistribute_inputs=True)(t)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``. On a mesh the gather has no sharding rule over a
    sharded table: the table is gathered whole (explicitly) and each rank
    looks up its own rows of the batch, which stay on the batch axes."""
    if not isinstance(table, DTensor):
        return table[tokens]
    return local_call(lambda e, t: e[t], (table, tokens), ((None, None), (BATCH_AXES, None)),
                      (BATCH_AXES, None, None), (*tokens.shape, table.shape[-1]))


def shard_tensor(t: torch.Tensor, mesh, pl) -> DTensor:
    """The DTensor over ``mesh`` whose global value is ``t`` (the same on
    every rank): each rank keeps its own block, cut locally with no
    communication (a contiguous block is a view; on a one-rank mesh the
    tensor itself). Every sharded dim must divide its mesh axes, as the
    partition rules ensure."""
    local = t
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            local = local.tensor_split(mesh.size(i), dim=p.dim)[mesh.get_local_rank(i)]
    return DTensor.from_local(local.contiguous(), mesh, pl, run_check=False)


def full(t):
    """A DTensor's global value as a plain tensor (an all-gather where it is
    sharded); anything else as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _block(t: DTensor) -> tuple[list[int], list[int]]:
    """(local shape, global offset) of this rank's block of ``t``, evenly
    sharded: each sharding mesh dim, in mesh order, cuts the block it is
    given into equal parts."""
    shape, offset = list(t.shape), [0] * t.ndim
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard):
            shape[p.dim] //= t.device_mesh.size(i)
            offset[p.dim] += t.device_mesh.get_local_rank(i) * shape[p.dim]
    return shape, offset


def write_rows(dst: torch.Tensor, src: torch.Tensor, pos: int) -> None:
    """``dst[:, pos:pos + s] = src`` in place (a cache write at one position).

    On a DTensor cache, which may shard the written dim (SP decode) as well
    as the batch and the heads, ``src`` is redistributed (explicitly) to the
    cache's placements with that dim whole, and each rank writes the rows
    that fall in its own block of ``dst``."""
    s = src.shape[1]
    if not isinstance(dst, DTensor):
        dst[:, pos:pos + s] = src.to(dst.dtype)
        return
    mesh = dst.device_mesh
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p for p in dst.placements)
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim, run_check=False)
    src = src.redistribute(mesh, pl).to_local()
    local = dst.to_local()
    shape, offset = _block(dst)
    lo, hi = max(pos, offset[1]), min(pos + s, offset[1] + shape[1])
    if lo < hi:
        local[:, lo - offset[1]:hi - offset[1]] = src[:, lo - pos:hi - pos].to(local.dtype)


def has_sharding_rule(func) -> bool:
    """Whether this torch's DTensor has a sharding rule (or its own
    handler) for ``func``; the tables differ between versions."""
    prop = DTensor._op_dispatcher.sharding_propagator
    tables = [getattr(prop, n, {}) for n in ("op_strategy_funcs", "op_to_rules",
                                                 "op_single_dim_strategy_funcs")]
    tables.append(getattr(DTensor._op_dispatcher, "_custom_op_handlers", {}))
    return any(func in t for t in tables)


class NoRuleFallback(TorchDispatchMode):
    """Ops on DTensors that this torch's DTensor has no sharding rule for
    (torch 2.11 has none for ``flip``, which the backward of ``cumsum``
    runs, nor for ``ne.Tensor``): every DTensor argument is redistributed
    whole (an explicit all-gather or all-reduce), the op runs on the local
    tensors, and its outputs come back replicated. Ops with a rule go to
    DTensor untouched. ``fallbacks`` counts the ops handled here by name."""

    def __init__(self):
        super().__init__()
        self.fallbacks: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        if has_sharding_rule(func):
            return NotImplemented          # DTensor's own rule
        if func._schema.is_mutable:
            raise NotImplementedError(f"{func} has no sharding rule and writes in place")
        flat, spec = tree_flatten((args, kwargs))
        mesh = next(a.device_mesh for a in flat if isinstance(a, DTensor))
        whole = [Replicate()] * mesh.ndim
        flat = [a.redistribute(mesh, whole).to_local() if isinstance(a, DTensor) else a
                for a in flat]
        args, kwargs = tree_unflatten(flat, spec)
        out = func(*args, **kwargs)
        return tree_map_only(torch.Tensor,
                             lambda t: DTensor.from_local(t, mesh, whole, run_check=False), out)


@contextlib.contextmanager
def mesh_scope():
    """Where the model runs on DTensors: the plain tensors it makes inside
    (positions, masks) count as replicated (``implicit_replication``), and
    ops without a sharding rule take :class:`NoRuleFallback`."""
    from torch.distributed.tensor.experimental import implicit_replication

    with implicit_replication(), NoRuleFallback():
        yield
