"""Device meshes (the port's counterpart of ``repro.launch.mesh``).

A ``Mesh`` names the axes of a grid of ranks: ``shape`` maps each axis
name to its size (as a JAX mesh's ``shape`` does) and ``axis_names``
keeps their order.  An unbound mesh carries only these and serves the
spec arithmetic of ``sharding/rules.py`` at any size (the production
meshes below have 256 or 512 ranks and are never bound here).

``place`` puts a mesh on one rank with no world at all (the dry run,
``launch/dryrun.py``): rank r's coordinates as ``bind`` would give them,
``axis_index`` / ``axis_size`` as on a bound mesh, but no process group
(``get_group`` returns None) and ``bound`` False; the collectives of
``sharding/comm.py`` then compute nothing and only count.

``bind`` ties a mesh to the initialized ``torch.distributed`` world
through ``torch.distributed.device_mesh.init_device_mesh``: rank r sits
at the row-major coordinates of r in ``shape``, each axis gets its
process group (``get_group``), and ``axis_index(name)`` is this rank's
coordinate on an axis.  A bound mesh runs on ``cuda`` (NCCL; rank r on
card r modulo the host's cards unless ``device`` names one) unless the
caller passes ``device="cpu"`` (gloo); there is no fallback between the
two.  Every collective of the port goes through ``sharding/comm.py`` over
these groups.

Production topology of the reference (the axes the rules read):
  single pod:  (16, 16)      axes ("data", "model")
  multi pod:   (2, 16, 16)   axes ("pod", "data", "model")

``model`` carries the expert-parallel and tensor-parallel collectives;
``data`` (and ``pod``) the gradient reduction.
"""

from __future__ import annotations

import math
from itertools import product
from typing import Dict, Optional, Tuple

import torch


class Mesh:
    """Named axes over a grid of ranks; bound to a process group world by
    ``bind``."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} vs axes {axis_names}")
        self.axis_sizes = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        self.device: Optional[torch.device] = None
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._coords: Optional[Tuple[int, ...]] = None
        #: placed on one rank with no world (``place``)
        self.placed = False
        #: shardings derived from a config on this mesh, memoized by
        #: ``sharding.rules.fsdp_layout``
        self.layouts: Dict = {}

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (a JAX mesh's ``shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def bound(self) -> bool:
        return self._coords is not None and not self.placed

    def __repr__(self) -> str:
        state = (f"bound on {self.device}" if self.bound else
                 f"rank {self.rank} placed on {self.device}" if self.placed
                 else "unbound")
        return f"Mesh({self.shape}, {state})"

    @property
    def rank(self) -> int:
        """The row-major rank of this process's coordinates."""
        r = 0
        for size, c in zip(self.axis_sizes, self.coordinates()):
            r = r * size + c
        return r

    # ------------------------------------------------------------------ #
    # binding to the torch.distributed world
    # ------------------------------------------------------------------ #

    def bind(self, device=None) -> "Mesh":
        """Tie this mesh to the initialized world (every rank calls it, in
        the same order as any other group creation): one process group
        per axis and one over the axes other than ``model`` when there
        are several.  Raises when no world is initialized or its size is
        not the product of the shape."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        if not dist.is_initialized():
            raise RuntimeError("bind a mesh after "
                               "torch.distributed.init_process_group")
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(f"mesh {self.shape} needs {self.size} ranks; "
                             f"the world has {world}")
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("CUDA is not available; bind the mesh "
                                   "with device='cpu' to run over gloo on "
                                   "the CPU")
            # one process a card: rank r on card r of its host, unless the
            # caller named one
            if dev.index is None:
                dev = torch.device("cuda", dist.get_rank()
                                   % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        dm = init_device_mesh(dev.type, self.axis_sizes,
                              mesh_dim_names=self.axis_names)
        self._groups = {(a,): dm.get_group(a) for a in self.axis_names}
        self._groups[self.axis_names] = dist.group.WORLD
        data = tuple(a for a in self.axis_names if a != "model")
        if len(data) > 1:
            self._groups[data] = _new_group_over(self, data)
        self._coords = tuple(int(c) for c in dm.get_coordinate())
        self.device = dev
        return self

    def place(self, rank: int = 0, device="meta") -> "Mesh":
        """Put this (unbound) mesh on ``rank`` with no ``torch.distributed``
        world: the rank's row-major coordinates, no process group.  The
        port's per-rank program then runs as rank ``rank`` would, on
        ``device`` (``meta``: shapes only), with every collective a count
        (``sharding/comm.py``)."""
        if self.bound:
            raise RuntimeError(f"{self!r} is bound to a world; place an "
                               "unbound mesh")
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is not in a mesh of {self.size}")
        coords = []
        for size in reversed(self.axis_sizes):
            rank, c = divmod(rank, size)
            coords.append(c)
        self._coords = tuple(reversed(coords))
        self.placed = True
        self.device = torch.device(device)
        return self

    def _need_bound(self) -> None:
        if self._coords is None:
            raise RuntimeError(f"{self!r}: bind it to a process group world "
                               "first (Mesh.bind), or place it (Mesh.place)")

    def axes(self, axes) -> Tuple[str, ...]:
        """``axes`` (a name or names) in mesh order."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in names:
            if a not in self.axis_names:
                raise ValueError(f"no axis {a!r} in {self.axis_names}")
        return tuple(a for a in self.axis_names if a in names)

    def get_group(self, axes):
        """The process group over ``axes`` (a name or names) holding this
        rank; None on a placed mesh, which has no world."""
        self._need_bound()
        key = self.axes(axes)
        if self.placed:
            return None
        if key not in self._groups:
            raise ValueError(f"no process group over {key}; a bound mesh "
                             f"has {sorted(self._groups)}")
        return self._groups[key]

    def coordinates(self) -> Tuple[int, ...]:
        self._need_bound()
        return self._coords

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes`` (names: row-major over them in
        mesh order), ``jax.lax.axis_index``'s counterpart."""
        coords = dict(zip(self.axis_names, self.coordinates()))
        idx = 0
        for a in self.axes(axes):
            idx = idx * self.shape[a] + coords[a]
        return idx

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self.axes(axes))


def _new_group_over(mesh: Mesh, axes: Tuple[str, ...]):
    """A process group over several axes: every rank creates every group
    of the partition (``new_group`` is collective), keeps its own."""
    import torch.distributed as dist
    rest = [a for a in mesh.axis_names if a not in axes]
    mine = None
    rank = dist.get_rank()
    for fixed in product(*(range(mesh.shape[a]) for a in rest)):
        ranks = []
        for free in product(*(range(mesh.shape[a]) for a in axes)):
            coord = dict(zip(rest, fixed)) | dict(zip(axes, free))
            r = 0
            for a in mesh.axis_names:
                r = r * mesh.shape[a] + coord[a]
            ranks.append(r)
        g = dist.new_group(ranks)
        if rank in ranks:
            mine = g
    return mine


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production topology, unbound (spec arithmetic)."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_test_mesh(shape=(2, 2), axes=("data", "model")) -> Mesh:
    """A small unbound mesh; ``.bind(device=...)`` in an initialized
    world of ``prod(shape)`` ranks."""
    return Mesh(tuple(shape), tuple(axes))


def chips(mesh: Mesh) -> int:
    return mesh.size
