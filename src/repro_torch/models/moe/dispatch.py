"""Dispatch/Combine stage: token movement between router and expert
compute, in two families (as ``repro.models.moe.dispatch``).

**Capacity buffers** (``dense``, GShard): token copies are scattered into
fixed ``[E, C, D]`` buffers with token-major slot priority; copies past an
expert's capacity are dropped.

**Sort-based dropless** (``gmm``): token copies are argsorted by expert id
and packed into a flat ``[M, D]`` buffer whose expert groups are padded to
a multiple of the row tile ``block_m``.  ``SortPlan`` carries what Compute
and Combine need, including the per-tile expert map the ``moe_gmm`` kernel
reads.

Shapes in both depend only on (T, k, E, C or block_m), never on the
routing data, so neither costs a device-to-host copy.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


# --------------------------------------------------------------------------- #
# Capacity-buffer family (dense)
# --------------------------------------------------------------------------- #


def _expert_groups(flat_e: torch.Tensor, num_experts: int):
    """Stable (token-major) sort of flat token copies by expert id ->
    (order, sizes [E], sorted_e, rank): ``rank[i]`` is sorted copy i's
    index within its expert's group, the count of earlier copies to the
    same expert."""
    n = flat_e.numel()
    order = torch.argsort(flat_e, stable=True)
    # scatter-add, not bincount: bincount syncs the host to size its output
    sizes = torch.zeros(num_experts, dtype=torch.long, device=flat_e.device)
    sizes.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(sizes, 0) - sizes                       # exclusive
    sorted_e = flat_e[order]
    rank = torch.arange(n, device=flat_e.device) - starts[sorted_e]
    return order, sizes, sorted_e, rank


def _slot_positions(idx: torch.Tensor, num_experts: int, cap: int):
    """Per (token, k-slot) position within its expert's capacity buffer.

    Token-major priority: copies are flattened [T, k] -> [T*k], and a
    copy's position is the count of earlier copies to the same expert, so
    earlier tokens keep their slots under overflow.  The reference counts
    with a cumsum down a [T*k, E] one-hot; a stable sort gives the same
    positions (that scan took 3 ms a layer on an H100 at 2048 tokens x
    top-8, as long as the layer's expert kernel).  Returns (pos [T,k]
    int64, keep [T,k] bool = pos < cap)."""
    t, k = idx.shape
    order, _, _, rank = _expert_groups(idx.reshape(-1).long(), num_experts)
    pos = torch.empty_like(rank)
    pos[order] = rank
    pos = pos.reshape(t, k)
    return pos, pos < cap


def _scatter(x2d: torch.Tensor, idx_eff: torch.Tensor, pos: torch.Tensor,
             keep: torch.Tensor, n_rows: int, cap: int) -> torch.Tensor:
    """Token copies into capacity buffers [n_rows, cap, D] (zero where no
    copy lands).  Every dropped copy goes to one trash row past the
    buffers: real slots are an injection, and the trash row, written in
    no fixed order, is cut off."""
    k = idx_eff.shape[1]
    slot = idx_eff.long() * cap + torch.where(keep, pos, 0)
    flat_slot = torch.where(keep, slot, n_rows * cap).reshape(-1)
    buf = x2d.new_zeros((n_rows * cap + 1, x2d.shape[-1]))
    buf[flat_slot] = x2d.repeat_interleave(k, dim=0)
    return buf[: n_rows * cap].reshape(n_rows, cap, -1)


def _gather_combine(ye: torch.Tensor, weights: torch.Tensor,
                    idx_eff: torch.Tensor, pos: torch.Tensor,
                    keep: torch.Tensor, cap: int) -> torch.Tensor:
    """ye [n_rows, C, D] -> y [T, D] f32, the router-weighted sum of each
    token's copies; a dropped copy reads its expert's row 0 at weight 0."""
    t, k = idx_eff.shape
    slot = (idx_eff.long() * cap + torch.where(keep, pos, 0)).reshape(-1)
    gathered = ye.reshape(-1, ye.shape[-1])[slot].reshape(t, k, -1)
    return torch.einsum("tkd,tk->td", gathered.float(),
                        (weights * keep).float())


# --------------------------------------------------------------------------- #
# Sort-based dropless family (gmm)
# --------------------------------------------------------------------------- #


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
    order, sizes, sorted_e, rank = _expert_groups(idx.reshape(-1).long(),
                                                  num_experts)
    padded = (sizes + bm - 1) // bm * bm
    pstarts = torch.cumsum(padded, 0) - padded
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
