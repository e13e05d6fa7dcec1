"""Collective operand bytes per op kind (the port's counterpart of
``repro.analysis.hlo``).

The reference parses the compiled, partitioned HLO text of a step for its
collectives.  The port issues its collectives one call at a time through
``sharding/comm.py``, which reports each call here: ``record()`` is a
context manager around port code that yields a ``CollectiveStats`` filled
by every collective issued inside it.  A step captured as a CUDA graph
reports its collectives at each replay, as an eager step does at each
call (``held``).  Bytes are per rank and follow the reference's operand
conventions (``hlo.py``):

    all-reduce          operand == result
    all-to-all          operand == result
    collective-permute  operand == result
    all-gather          operand == result / group_size
    reduce-scatter      operand == result * group_size
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Tuple

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")


def operand_bytes(kind: str, result_bytes: int, group_size: int = 1) -> int:
    """A collective's operand bytes from its result's (the conventions
    above)."""
    if kind not in _COLLECTIVES:
        raise ValueError(f"unknown collective {kind!r}; have {_COLLECTIVES}")
    if kind == "all-gather":
        return result_bytes // max(group_size, 1)
    if kind == "reduce-scatter":
        return result_bytes * group_size
    return result_bytes


@dataclass
class CollectiveStats:
    """Per-rank collective traffic summed over what was recorded."""

    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())

    def add(self, kind: str, result_bytes: int, group_size: int = 1) -> None:
        """Count one collective by its result's bytes."""
        b = operand_bytes(kind, result_bytes, group_size)
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + b
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1

    def summary(self) -> str:
        parts = [f"{k}: n={self.count_by_kind[k]} "
                 f"bytes={self.bytes_by_kind[k]:,}"
                 for k in sorted(self.bytes_by_kind)]
        return "; ".join(parts) if parts else "none"


#: the stats objects of the ``record()`` blocks open now, innermost last
_ACTIVE: List[CollectiveStats] = []
#: the notes held back by the ``held()`` blocks open now, innermost last
_HELD: List[List[Tuple[str, int, int]]] = []
#: collectives running now (``transfer``); their own aten work is their
#: transfer, which ``analysis/counters.py`` leaves out of the HBM bytes
_DEPTH = [0]


@contextmanager
def record() -> Iterator[CollectiveStats]:
    """Collect the collectives issued inside the block (nested blocks each
    see their own and their children's)."""
    stats = CollectiveStats()
    _ACTIVE.append(stats)
    try:
        yield stats
    finally:
        _ACTIVE.remove(stats)


def note(kind: str, result_bytes: int, group_size: int = 1) -> None:
    """Report one collective to every open ``record()`` block, or hold it
    back inside a ``held()`` block."""
    if _HELD:
        _HELD[-1].append((kind, result_bytes, group_size))
        return
    for stats in _ACTIVE:
        stats.add(kind, result_bytes, group_size)


@contextmanager
def held() -> Iterator[List[Tuple[str, int, int]]]:
    """Hold back the collectives noted inside the block and yield them, in
    order, as ``note``'s arguments: a CUDA graph capture runs none of the
    collectives it records, and each replay of the graph notes them again
    (``kernels/_graphs.py``)."""
    notes: List[Tuple[str, int, int]] = []
    _HELD.append(notes)
    try:
        yield notes
    finally:
        _HELD.remove(notes)



@contextmanager
def transfer() -> Iterator[None]:
    """Mark the body of one collective: the copies it makes into and out of
    its buffers are the collective's bytes (``note``), not the step's HBM
    traffic (``in_transfer``, read by ``analysis/counters.py``)."""
    _DEPTH[0] += 1
    try:
        yield
    finally:
        _DEPTH[0] -= 1


def in_transfer() -> bool:
    """A collective's body is running (``transfer``)."""
    return _DEPTH[0] > 0
