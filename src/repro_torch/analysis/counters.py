"""What a step of the port's per-rank program costs, counted as it runs:
the counterpart of XLA's ``cost_analysis()`` and ``memory_analysis()``
that the reference reads off a compiled module (``analysis/roofline.py``).

``count(inputs)`` is a context manager around a step that yields a
``Counts``:

* ``flops``: the aten matrix products (``torch.utils.flop_counter.
  FlopCounterMode``: mm, bmm and its ``out_dtype`` form, addmm, baddbmm,
  einsum's products, convolutions, SDPA; forward and backward) plus the
  FLOPs each kernel launch reports (``kernels/costs.py``).
* ``nbytes``: every non-view aten op's input and output bytes (a view, a
  ``reshape`` that does not copy, ``expand``, ``slice``, ``select``,
  ``transpose``, ``permute``, ``t``, ``unsqueeze``, ``squeeze``,
  ``as_strided``, ``detach``, ``alias``: 0; so is an allocation, ``empty``
  and its kin, which moves no byte) plus the bytes each kernel launch
  reports.  The aten work inside a collective (``analysis.collectives.
  transfer``: the copies into and out of its buffers) is not counted
  here: it is the collective's.  Ops outside the ``aten`` namespace
  (``c10d``'s) are not counted either.
* ``collectives``: the per-rank collective bytes and calls by kind
  (``analysis.collectives.record()``).
* ``peak_bytes``: the most bytes held at once by the storages of
  ``inputs`` plus those the step allocates, each freed when its last
  reference dies (autograd's saved tensors included): the counterpart of
  ``memory_analysis()``'s arguments + temps + outputs - aliases.  A
  storage is keyed by its ``StorageImpl`` (``_cdata``; a meta storage's
  ``data_ptr()`` is 0), and its death is seen through a weak reference
  to its Python object, which torch keeps alive as long as the storage
  (checked when a block opens: torch 2.13 here, and the card's; an older
  torch that makes the object anew at each access is refused).  Tensors
  that live outside ``inputs`` and are not made inside the block (a
  module's cached buffers) are not counted.

The counts describe the port's **eager** program, one aten op at a time:
nothing is fused, so every elementwise op's operands travel to and from
memory, and elementwise FLOPs are not counted at all (XLA counts them,
and fuses).  A rank's FLOPs and bytes here are therefore not comparable
with the reference's ``cost_analysis()`` numbers; the roofline built on
them (``analysis/roofline.py``) is the port's own.

The collective counts are those of ``sharding/comm.py``'s ``note``,
forward and backward: every differentiable collective there is the
module's own autograd function, whose backward notes the collective it
runs on the gradient.

On ``meta`` (``launch/dryrun.py``) the same program computes nothing, and
the counts are those of the same step on the card (``chip_smoke.py``'s
``dryrun`` phase holds the two equal).
"""

from __future__ import annotations

import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field
from functools import partial
from typing import Dict, Iterator, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.collectives import CollectiveStats, in_transfer, \
    record


@dataclass
class Counts:
    aten_flops: int = 0
    aten_bytes: int = 0
    kernel_flops: int = 0
    kernel_bytes: int = 0
    #: kernel name -> launches reported
    kernel_calls: Dict[str, int] = field(default_factory=dict)
    collectives: CollectiveStats = field(default_factory=CollectiveStats)
    #: bytes of the inputs' storages when the block began
    input_bytes: int = 0
    peak_bytes: int = 0

    @property
    def flops(self) -> int:
        return self.aten_flops + self.kernel_flops

    @property
    def nbytes(self) -> int:
        return self.aten_bytes + self.kernel_bytes

    def as_dict(self) -> Dict:
        return {"flops": self.flops, "aten_flops": self.aten_flops,
                "kernel_flops": self.kernel_flops, "bytes": self.nbytes,
                "aten_bytes": self.aten_bytes,
                "kernel_bytes": self.kernel_bytes,
                "kernel_calls": dict(self.kernel_calls),
                "collective_bytes": dict(self.collectives.bytes_by_kind),
                "collective_calls": dict(self.collectives.count_by_kind),
                "input_bytes": self.input_bytes,
                "peak_bytes": self.peak_bytes}


#: the ``Counts`` of the ``count()`` blocks open now
_ACTIVE: List[Counts] = []


def add_kernel(name: str, flops: int, nbytes: int) -> None:
    """One kernel launch's cost (``kernels/costs.py::report``) to every
    open block."""
    for c in _ACTIVE:
        c.kernel_calls[name] = c.kernel_calls.get(name, 0) + 1
        c.kernel_flops += flops
        c.kernel_bytes += nbytes


_aten = torch.ops.aten
#: allocations: they move no byte
_ALLOC = {_aten.empty, _aten.empty_like, _aten.empty_strided,
          _aten.new_empty, _aten.new_empty_strided, _aten.empty_permuted}
#: ``reshape``'s no-copy form, which the schema does not mark as a view
_NO_COPY = {_aten._unsafe_view, _aten._reshape_alias}


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class _Live:
    """The storages alive now and the most bytes they held at once.  A
    storage's Python object lives as long as its ``StorageImpl`` (torch
    keeps it alive from C++), so a weak reference's callback marks the
    moment the last reference dies, autograd's included; the key
    (``_cdata``) is not reused before then."""

    def __init__(self):
        probe = torch.empty(1, device="meta")
        if probe.untyped_storage() is not probe.untyped_storage():
            raise RuntimeError(
                f"torch {torch.__version__} makes a storage's Python object "
                "anew at each access; the peak of live bytes needs one that "
                "lives as long as the storage")
        self.refs: Dict[int, weakref.ref] = {}
        self.now = 0
        self.peak = 0

    def add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.refs:
            return
        n = st.nbytes()
        self.refs[key] = weakref.ref(st, partial(self._free, key, n))
        self.now += n
        self.peak = max(self.peak, self.now)

    def _free(self, key: int, n: int, _ref) -> None:
        if self.refs.pop(key, None) is not None:
            self.now -= n


class _Mode(TorchDispatchMode):
    def __init__(self, counts: Counts, live: _Live):
        super().__init__()
        self.counts, self.live = counts, live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self.live.add(t)
        if (func.namespace == "aten" and not func.is_view and not in_transfer()
                and func.overloadpacket not in _ALLOC
                and func.overloadpacket not in _NO_COPY):
            self.counts.aten_bytes += (_bytes(_tensors((args, kwargs)))
                                       + _bytes(outs))
        return out


def _bmm_flop(a_shape, b_shape, out_dtype=None, *, out_shape=None,
              **kwargs) -> int:
    """``bmm``'s FLOPs, its ``out_dtype`` form (``bmm.dtype``) too: the
    stock formula, registered for the whole overload packet, takes that
    form's third argument for the output's shape and raises."""
    n, m, k = a_shape
    return 2 * n * m * k * b_shape[2]


@contextmanager
def count(inputs=None) -> Iterator[Counts]:
    """Count the step run inside the block (module doc); ``inputs``: the
    trees whose storages the step holds from the start (params, optimizer
    state, batch, caches).  The FLOPs are filled in when the block ends."""
    from torch.utils.flop_counter import FlopCounterMode
    counts = Counts()
    live = _Live()
    for t in _tensors(inputs):
        live.add(t)
    counts.input_bytes = live.now
    flop_mode = FlopCounterMode(display=False,
                                custom_mapping={_aten.bmm: _bmm_flop})
    _ACTIVE.append(counts)
    try:
        with record() as stats, flop_mode, _Mode(counts, live):
            counts.collectives = stats
            yield counts
    finally:
        _ACTIVE.remove(counts)
        counts.aten_flops = int(flop_mode.get_total_flops())
        counts.peak_bytes = live.peak
