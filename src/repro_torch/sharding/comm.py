"""Collectives over the axes of a bound mesh (``launch/mesh.py``).

The port's counterparts of the ``jax.lax`` collectives the reference's
shard_map bodies call (``all_to_all``, ``psum``, ``pmax``, ``pmean``,
``all_gather``), as a per-rank program: each rank calls them with its own
operand, every rank of the group in the same order.  ``all_to_all``,
``psum``, ``pmean`` and ``all_gather`` are differentiable (the backward
of an all-to-all is the reverse all-to-all, of a sum the sum of the
gradients), so the gradients of the summed per-rank losses flow across
ranks as the reference's transposes do.  ``pmax`` is not: its users (the
log-sum-exp merges of context-parallel decode and of the vocab-parallel
cross-entropy, the compression's amax) take no gradient through it.

Tensor parallelism keeps another rule for the gradients (Megatron's): an
activation replicated over ``model`` carries the whole gradient on every
rank, so the ranks of a ``model`` group compute one loss.  Its four
operators over ``model`` pair a forward with the backward that rule asks
for: ``copy_to_model`` (Megatron's *f*: identity, then a sum of the
gradients; at the input of every column-parallel block),
``reduce_from_model`` (*g*: a sum, then identity; after every
row-parallel block), ``gather_from_model`` (an all-gather whose backward
keeps the rank's block) and ``split_to_model`` (the rank's block, whose
backward all-gathers).  ``all_gather``'s backward is a reduce-scatter: it
serves a gathered tensor that each rank then reads only in part (the heads
of a column block that cuts through a head) and the FSDP weights gathered
over the data axes.  ``reduce_scatter`` is the ZeRO-1 and FSDP gradient
step's.

Each call, forward or backward, reports its operand bytes to the open
``analysis.collectives.record()`` blocks, and runs its body inside
``analysis.collectives.transfer()`` (the copies into and out of its
buffers are the collective's bytes, not the step's HBM traffic:
``analysis/counters.py``).  A group of one rank still runs its collective
(NCCL or gloo then copies), so a one-card mesh counts the same calls a
larger one makes.  A step captured as a CUDA graph runs its collectives
at each replay and notes them there (``kernels/_graphs.py``).  Nothing
else in the port calls ``torch.distributed`` collectives; ``agree``,
the host's check that the ranks are in step, is bookkeeping and is not
noted.

On a placed mesh (``Mesh.place``: one rank, no world; the dry run) every
collective computes nothing: it reports the same ``note`` as on a bound
mesh and returns an empty tensor of its result's shape, dtype and device;
``barrier`` does nothing.  Every differentiable collective is one of
this module's autograd functions, whose backward calls the module's own
collective on the gradient: on a placed mesh that is the same placed
collective, so a train step notes its backward's all-to-alls, sums and
gathers alike on a placed mesh and on a bound one (the reference counts
every collective of its partitioned step, forward and backward).
"""

from __future__ import annotations

import torch

from repro_torch.analysis.collectives import note, transfer
from repro_torch.launch.mesh import Mesh


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """x [n, ...] (n = the axis size): block i goes to the axis' rank i;
    the result's block j came from rank j (``jax.lax.all_to_all`` with
    ``split_axis = concat_axis = 0``)."""
    n = mesh.axis_size(axis)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all over {axis!r} ({n} ranks) needs dim 0 "
                         f"of {n}, got {tuple(x.shape)}")
    return _AllToAll.apply(x, mesh, axis)


def psum(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """The sum over the ranks of ``axes`` (a name or names); the backward
    sums the gradient the same way."""
    return _Psum.apply(x, mesh, axes)


def pmean(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    return psum(x, mesh, axes) / mesh.axis_size(axes)


@torch.no_grad()
def pmax(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """The elementwise max over the ranks of ``axes``; no gradient."""
    import torch.distributed as dist
    with transfer():
        note("all-reduce", _nbytes(x), mesh.axis_size(axes))
        if mesh.placed:
            return _empty(x.shape, x)
        out = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.MAX,
                        group=mesh.get_group(axes))
        return out


def all_gather(x: torch.Tensor, mesh: Mesh, axes, dim: int = 0
               ) -> torch.Tensor:
    """The ranks' blocks of ``axes`` concatenated along ``dim``, in rank
    order along them; the backward sums the gradient over the ranks and
    keeps each its block (a reduce-scatter; torch's own autograd gather
    addresses a subgroup's ranks as global ranks on gloo)."""
    return _AllGather.apply(x, mesh, axes, dim)


def agree(value, mesh: Mesh, what: str) -> None:
    """Raise unless every rank of the mesh passes an equal ``value`` (a
    host object): the ranks' check that they run the same program.  Not a
    step's collective: nothing is noted, and a placed mesh, which has one
    rank, checks nothing."""
    import torch.distributed as dist
    if mesh.placed:
        return
    got = [None] * mesh.size
    dist.all_gather_object(got, value, group=mesh.get_group(mesh.axis_names))
    if any(v != value for v in got):
        raise RuntimeError(f"the ranks are out of step: {what} {got} (rank "
                           f"order)")


def barrier(mesh: Mesh) -> None:
    """Every rank of the mesh reaches this point before any goes on."""
    import torch.distributed as dist
    mesh.coordinates()                       # bound or placed
    if not mesh.placed:
        dist.barrier(group=mesh.get_group(mesh.axis_names))


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axes, dim: int = 0
                   ) -> torch.Tensor:
    """The sum over the ranks of ``axes``, of which each rank keeps its
    block along ``dim`` (no gradient)."""
    import torch.distributed as dist
    n = mesh.axis_size(axes)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter over {axes!r} ({n} ranks): dim "
                         f"{dim} of {tuple(x.shape)} does not split")
    with transfer():
        note("reduce-scatter", _nbytes(x) // n, n)
        if mesh.placed:
            return _empty(_resized(x.shape, dim, x.shape[dim] // n), x)
        group = mesh.get_group(axes)
        x = x.detach()
        if dist.get_backend(group) == "nccl":
            xt = x.movedim(dim, 0).contiguous()
            out = torch.empty((xt.shape[0] // n,) + tuple(xt.shape[1:]),
                              dtype=x.dtype, device=x.device)
            dist.reduce_scatter_tensor(out, xt, group=group)
            return out.movedim(0, dim).contiguous()
        # gloo has no reduce-scatter: a sum, of which the rank keeps its
        # block
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return _block(out, mesh, axes, dim).contiguous()


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _exchange(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.mesh, ctx.axis), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.mesh, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter(g, ctx.mesh, ctx.axes, ctx.dim), None, None,
                None)


# --------------------------------------------------------------------------- #
# Tensor parallelism over ``model`` (module doc)
# --------------------------------------------------------------------------- #


def _all_reduce(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    import torch.distributed as dist
    with transfer():
        note("all-reduce", _nbytes(x), mesh.axis_size(axes))
        if mesh.placed:
            return _empty(x.shape, x)
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=mesh.get_group(axes))
        return out


def _exchange(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    import torch.distributed as dist
    with transfer():
        x = x.contiguous()
        note("all-to-all", _nbytes(x), mesh.axis_size(axis))
        if mesh.placed:
            return _empty(x.shape, x)
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=mesh.get_group(axis))
        return out


def _gather(x: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    import torch.distributed as dist
    n = mesh.axis_size(axes)
    with transfer():
        x = x.contiguous()
        note("all-gather", _nbytes(x) * n, n)
        if mesh.placed:
            return _empty(_resized(x.shape, dim, x.shape[dim] * n), x)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=mesh.get_group(axes))
        return torch.cat(parts, dim=dim)


# --------------------------------------------------------------------------- #
# A placed mesh's collectives (module doc)
# --------------------------------------------------------------------------- #


def _empty(shape, like: torch.Tensor) -> torch.Tensor:
    """A placed collective's result: contiguous, nothing computed."""
    return torch.empty(tuple(shape), dtype=like.dtype, device=like.device)


def _resized(shape, dim: int, size: int):
    out = list(shape)
    out[dim] = size
    return out


def _block(x: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    n = mesh.axis_size(axes)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over "
                         f"{axes!r} ({n} ranks)")
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.axis_index(axes) * size, size)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (_block(g, ctx.mesh, ctx.axes, ctx.dim).contiguous(), None,
                None, None)


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _block(x, mesh, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Identity; the backward sums the gradient over ``model`` (Megatron's
    *f*, ahead of a block each rank reads only in part)."""
    return _CopyTo.apply(x, mesh, "model")


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over ``model``; the backward passes the gradient on as it is
    (Megatron's *g*, after a row-parallel block)."""
    return _ReduceFrom.apply(x, mesh, "model")


def gather_from_model(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """The ranks' blocks along ``dim`` concatenated in rank order, into a
    tensor every rank then reads whole; the backward keeps the rank's
    block of the gradient."""
    return _GatherFrom.apply(x, mesh, "model", dim)


def split_to_model(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """The rank's block along ``dim`` of a tensor the same on every rank of
    ``model``; the backward all-gathers the blocks' gradients."""
    return _SplitTo.apply(x, mesh, "model", dim)
