"""KV cache manager: the paged block-table pool, or contiguous slot rows.

The manager owns the device-side per-layer caches plus the host-side
accounting, as ``repro.serving.kv_cache`` does.  Two layouts:

``paged``
    A slot's logical block j maps to a physical page through
    ``table[slot, j]``; pages are handed out at admission (``allocate``),
    grown page by page as decode crosses page boundaries
    (``allocate_append``), and recycled on ``release`` with their ``posp``
    entries reset to -1, so a recycled page can never leak a previous
    request's positions past the mask.  Both allocations are all or
    nothing: a shortfall leaves the pool exactly as found.  The manager is
    policy-free; the engine decides whom to preempt.
``contiguous``
    One ``[max_len]`` row per slot, reserved for a request's whole
    lifetime: ``allocate`` and ``release`` only reset the row's ``pos`` to
    -1 (the k / v bytes left behind are masked by it), and a whole-prompt
    prefill writes into ``[1, ...]`` views of its row.  The page accounting
    (``pages_needed``, ``free_pages``, ``fits_ever``, ``live_blocks``,
    ``block_tables``) belongs to the paged layout only.

The paged layout's device block table is one tensor for the manager's
whole life, refreshed in place when the host table changed: a step
captured as a CUDA graph reads the table at the address it was captured
at.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import TRASH_PAGE, cache_buf_len


class KVCache:
    """Owns the page pools + block tables for up to ``max_batch`` slots."""

    def __init__(self, cfg: ModelConfig, max_batch: int, max_len: int, *,
                 layout: str = "paged", page_size: int = 16,
                 num_pages: Optional[int] = None, device):
        if layout not in ("paged", "contiguous"):
            raise ValueError(f"unknown cache layout {layout!r}")
        self.cfg = cfg
        self.layout = layout
        self.max_batch = max_batch
        self.max_len = max_len
        self.device = device
        self.s_buf = cache_buf_len(cfg, max_len)
        if layout == "contiguous":
            self.caches = models.init_caches(cfg, max_batch, max_len,
                                             layout="contiguous",
                                             device=device)
            self.stats = {}
            return
        self.page_size = page_size
        self.blocks_per_slot = -(-self.s_buf // page_size)
        full = max_batch * self.blocks_per_slot
        # +1 for the reserved trash page unmapped table entries point at
        # (requests the pool can never hold are rejected via fits_ever)
        self.num_pages = (num_pages if num_pages is not None else full) + 1
        self.caches = models.init_caches(cfg, page_size=page_size,
                                         num_pages=self.num_pages,
                                         device=device)
        self._free: List[int] = list(range(self.num_pages - 1, TRASH_PAGE, -1))
        self.table = np.full((max_batch, self.blocks_per_slot), TRASH_PAGE,
                             np.int32)
        self._owned: List[List[int]] = [[] for _ in range(max_batch)]
        #: the device table, refreshed in place (``block_tables``) when
        #: ``_table_dirty``; on the card through pinned staging
        self._table_dev = torch.from_numpy(self.table.copy()).to(device)
        self._table_dirty = False
        self._staging: Optional[torch.Tensor] = None
        self._copied = None
        self.stats = {"pages_in_use": 0, "pages_peak": 0,
                      "free_low_watermark": self.free_pages()}

    # ------------------------------------------------------------------ #
    # Capacity accounting
    # ------------------------------------------------------------------ #
    def pages_needed(self, total_tokens: int) -> int:
        """Pages for a request touching ``total_tokens`` positions (ring
        semantics cap it at one full buffer)."""
        return -(-min(total_tokens, self.s_buf) // self.page_size)

    def free_pages(self) -> int:
        return len(self._free)

    def fits_ever(self, total_tokens: int) -> bool:
        """Could this request ever be admitted (even on an empty pool)?"""
        return self.pages_needed(total_tokens) <= self.num_pages - 1

    def live_blocks(self, slot_pos) -> int:
        """Walk bound for the paged decode kernel: how many table columns
        cover every page any live slot can attend now, rounded up to a
        power of two (the reference's bucketing, kept so both engines walk
        the same tables).  ``slot_pos`` is the per-slot position (-1 idle).
        """
        mx = max(1, min(int(np.max(slot_pos)) + 1, self.s_buf))
        need = -(-mx // self.page_size)
        bucket = 1
        while bucket < need:
            bucket *= 2
        return min(bucket, self.blocks_per_slot)

    # ------------------------------------------------------------------ #
    # Slot lifecycle
    # ------------------------------------------------------------------ #
    def allocate(self, slot: int, total_tokens: int = 0) -> bool:
        """Reserve pages covering positions [0, total_tokens); False (pool
        untouched) if the pool cannot.  A contiguous slot row is always
        free for its whole lifetime: its positions are cleared."""
        if self.layout != "paged":
            self._clear_slot(slot)
            return True
        assert not self._owned[slot], f"slot {slot} already allocated"
        return self._take(slot, self.pages_needed(total_tokens))

    def allocate_append(self, slot: int, total_tokens: int) -> bool:
        """Grow an allocated slot to cover positions [0, total_tokens); a
        no-op until the sequence crosses a page boundary.  False (slot and
        pool untouched) on a shortfall, so the engine can preempt a victim
        and retry."""
        assert self._owned[slot], f"slot {slot} has no allocation to grow"
        return self._take(slot, self.pages_needed(total_tokens)
                          - len(self._owned[slot]))

    def _take(self, slot: int, need: int) -> bool:
        """Append ``need`` pages to ``slot`` (all or nothing)."""
        if need <= 0:
            return True
        if need > len(self._free):
            return False
        pages = [self._free.pop() for _ in range(need)]
        have = len(self._owned[slot])
        self._owned[slot].extend(pages)
        self.table[slot, have:have + need] = pages
        self._table_dirty = True
        self.stats["pages_in_use"] += need
        self.stats["pages_peak"] = max(self.stats["pages_peak"],
                                       self.stats["pages_in_use"])
        self.stats["free_low_watermark"] = min(
            self.stats["free_low_watermark"], self.free_pages())
        return True

    def release(self, slot: int) -> None:
        """Return a slot's pages to the pool, their ``posp`` reset (paged),
        or clear the slot row's positions (contiguous)."""
        if self.layout != "paged":
            self._clear_slot(slot)
            return
        pages = self._owned[slot]
        if not pages:
            return
        self._reset_pages(pages)
        self._free.extend(reversed(pages))
        self.stats["pages_in_use"] -= len(pages)
        self._owned[slot] = []
        self.table[slot] = TRASH_PAGE
        self._table_dirty = True

    def slot_pages(self, slot: int) -> List[int]:
        """The physical pages backing ``slot``, in block order."""
        return self._owned[slot]

    def block_tables(self) -> torch.Tensor:
        """The device block table [max_batch, blocks_per_slot] int32: one
        tensor across allocations, refreshed in place from the host table
        when that changed, so steady-state decode steps pay no copy.  On the
        card the refresh is asynchronous, through pinned staging that is
        rewritten only once its last copy has run (no host sync)."""
        if self._table_dirty:
            src = torch.from_numpy(self.table)
            if self._table_dev.is_cuda:
                if self._staging is None:
                    self._staging = torch.empty(src.shape, dtype=src.dtype,
                                                pin_memory=True)
                    self._copied = torch.cuda.Event()
                self._copied.synchronize()
                self._staging.copy_(src)
                self._table_dev.copy_(self._staging, non_blocking=True)
                self._copied.record()
            else:
                self._table_dev.copy_(src)
            self._table_dirty = False
        return self._table_dev

    def _reset_pages(self, pages: List[int]) -> None:
        """posp = -1 on recycled pages so stale entries can't pass the mask."""
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        for layer in self.caches:
            layer["posp"][idx] = -1

    def _clear_slot(self, slot: int) -> None:
        """pos = -1 on a slot row (the k / v bytes are masked by it)."""
        for layer in self.caches:
            layer["pos"][slot] = -1
