"""Collectives over the axes of a bound mesh (``launch/mesh.py``).

The port's counterparts of the ``jax.lax`` collectives the reference's
shard_map bodies call (``all_to_all``, ``psum``, ``pmax``, ``pmean``,
``all_gather``), as a per-rank program: each rank calls them with its own
operand, every rank of the group in the same order.  ``all_to_all``,
``psum``, ``pmean`` and ``all_gather`` are differentiable
(``torch.distributed.nn.functional``: the backward of an all-to-all is the
reverse all-to-all, of a sum the sum of the gradients), so the gradients
of the summed per-rank losses flow across ranks as the reference's
transposes do.  ``pmax`` is not: its one user, the log-sum-exp merge of
context-parallel decode, runs without grad.

Each call reports its operand bytes to the open
``analysis.collectives.record()`` blocks.  A group of one rank still runs
its collective (NCCL or gloo then copies), so a one-card mesh counts the
same calls a larger one makes.  Nothing else in the port calls
``torch.distributed`` collectives.
"""

from __future__ import annotations

import warnings

import torch

from repro_torch.analysis.collectives import note
from repro_torch.launch.mesh import Mesh


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _functional():
    import torch.distributed.nn.functional as fn
    return fn


def _quiet():
    """Newer torch marks these autograd collectives deprecated with a
    warning a call; the functional collectives it points at are not
    differentiable on every version the card may hold."""
    return warnings.catch_warnings(action="ignore", category=FutureWarning)


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """x [n, ...] (n = the axis size): block i goes to the axis' rank i;
    the result's block j came from rank j (``jax.lax.all_to_all`` with
    ``split_axis = concat_axis = 0``)."""
    n = mesh.axis_size(axis)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all over {axis!r} ({n} ranks) needs dim 0 "
                         f"of {n}, got {tuple(x.shape)}")
    x = x.contiguous()
    note("all-to-all", _nbytes(x), n)
    with _quiet():
        return _functional().all_to_all_single(
            torch.empty_like(x), x, group=mesh.get_group(axis))


def psum(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """The sum over the ranks of ``axes`` (a name or names)."""
    import torch.distributed as dist
    note("all-reduce", _nbytes(x), mesh.axis_size(axes))
    with _quiet():
        return _functional().all_reduce(x, op=dist.ReduceOp.SUM,
                                        group=mesh.get_group(axes))


def pmean(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    return psum(x, mesh, axes) / mesh.axis_size(axes)


@torch.no_grad()
def pmax(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """The elementwise max over the ranks of ``axes``; no gradient."""
    import torch.distributed as dist
    note("all-reduce", _nbytes(x), mesh.axis_size(axes))
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.get_group(axes))
    return out


def all_gather(x: torch.Tensor, mesh: Mesh, axes, dim: int = 0
               ) -> torch.Tensor:
    """The ranks' blocks of ``axes`` concatenated along ``dim``, in rank
    order along them."""
    n = mesh.axis_size(axes)
    x = x.contiguous()
    note("all-gather", _nbytes(x) * n, n)
    with _quiet():
        parts = _functional().all_gather(x, group=mesh.get_group(axes))
    return torch.cat(parts, dim=dim)


def barrier(mesh: Mesh) -> None:
    """Every rank of the mesh reaches this point before any goes on."""
    import torch.distributed as dist
    mesh.coordinates()                       # bound
    dist.barrier(group=mesh.get_group(mesh.axis_names))
