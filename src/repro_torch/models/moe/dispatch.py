"""Dispatch/Combine stage for the sort-based dropless family (``gmm``).

Token copies are argsorted by expert id and packed into a flat ``[M, D]``
buffer whose expert groups are padded to a multiple of the row tile
``block_m``.  ``SortPlan`` carries what Compute and Combine need,
including the per-tile expert map the ``moe_gmm`` kernel reads.  Shapes
depend only on (T, k, E, block_m), never on the routing data, so a plan
costs no device-to-host copy.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SortPlan(NamedTuple):
    """One sorted dropless dispatch.

    ``dest[j]`` is the packed-buffer row of flat token copy ``j`` (token
    ``j // k``, slot ``j % k``) -- an injection into ``[0, num_rows)``.
    """

    dest: torch.Tensor                #: [T*k] int64 packed row per copy
    group_sizes: torch.Tensor         #: [E] int32 real rows per expert
    padded_group_sizes: torch.Tensor  #: [E] int32 rows incl. tile padding
    tile_expert: torch.Tensor         #: [n_tiles] int32 expert of each tile
    tile_valid: torch.Tensor          #: [n_tiles] int32 1 iff any real row
    block_m: int                      #: row-tile size
    num_rows: int                     #: M = n_tiles * block_m


def default_block_m(n_copies: int, cap: int = 128, floor: int = 1) -> int:
    """Row-tile size: 128 at scale, rounded to 8 from 8 copies, the next
    power of two below 8 copies; ``floor`` lets the kernel path keep 8."""
    if n_copies >= 8:
        return max(floor, min(cap, ((n_copies + 7) // 8) * 8))
    bm = 1
    while bm < n_copies:
        bm *= 2
    return max(floor, bm)


def make_sort_plan(idx: torch.Tensor, num_experts: int,
                   block_m: int) -> SortPlan:
    """Routing decision [T,k] -> SortPlan.  The packed buffer is sized for
    the worst-case per-group padding ``E*(block_m-1)``."""
    t, k = idx.shape
    n = t * k
    bm = block_m
    dev = idx.device
    n_tiles = (n + num_experts * (bm - 1) + bm - 1) // bm
    flat_e = idx.reshape(-1).long()                               # [N]
    order = torch.argsort(flat_e, stable=True)                    # token-major
    # scatter-add, not bincount: bincount syncs the host to size its output
    sizes = torch.zeros(num_experts, dtype=torch.long, device=dev)
    sizes.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(sizes, 0) - sizes                       # exclusive
    padded = (sizes + bm - 1) // bm * bm
    pstarts = torch.cumsum(padded, 0) - padded
    sorted_e = flat_e[order]
    rank = torch.arange(n, device=dev) - starts[sorted_e]
    dest = torch.empty(n, dtype=torch.long, device=dev)
    dest[order] = pstarts[sorted_e] + rank

    pends = torch.cumsum(padded, 0)
    tile_row0 = torch.arange(n_tiles, device=dev) * bm
    # right=True walks past zero-size (empty) groups
    tile_e = torch.searchsorted(pends, tile_row0, right=True)
    in_range = tile_e < num_experts
    tile_e = tile_e.clamp(max=num_experts - 1)
    local = tile_row0 - pstarts[tile_e]
    tile_valid = in_range & (local < sizes[tile_e])
    return SortPlan(dest, sizes.to(torch.int32), padded.to(torch.int32),
                    tile_e.to(torch.int32), tile_valid.to(torch.int32),
                    bm, n_tiles * bm)


def sort_dispatch(x2d: torch.Tensor, plan: SortPlan,
                  top_k: int) -> torch.Tensor:
    """x2d [T, D] -> packed sorted buffer [M, D] (padding rows zero)."""
    xs = x2d.new_zeros((plan.num_rows, x2d.shape[-1]))
    xs[plan.dest] = x2d.repeat_interleave(top_k, dim=0)
    return xs


def sort_combine(ys: torch.Tensor, weights: torch.Tensor,
                 plan: SortPlan) -> torch.Tensor:
    """ys [M, D] -> y [T, D] f32: unsort via ``dest``, weighted sum."""
    t, k = weights.shape
    gathered = ys[plan.dest].reshape(t, k, -1)
    return torch.einsum("tkd,tk->td", gathered.float(), weights.float())
