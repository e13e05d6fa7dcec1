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
    -1 (the k / v bytes left behind are masked by it), and zero a mamba
    layer's conv and SSM state rows (the next prefill starts from them).  The page accounting
    (``pages_needed``, ``free_pages``, ``fits_ever``, ``live_blocks``,
    ``block_tables``) belongs to the paged layout only.

With ``prefix_cache=True`` (paged only) pages are refcounted (``ref``) and
may be shared across slots (DESIGN.md §8): admission adopts already
computed pages into a new slot's table through ``allocate(...,
shared=...)``, a partly reused boundary page is copied before any write
(copy-on-write: no write may land in a page with refcount > 1), and a
released page whose content the ``PrefixIndex`` holds parks, content
intact, in an LRU of evictable cached pages instead of the free list.  The
free pool is then the free list plus the LRU: ``_pop_pages`` evicts the
oldest cached pages (unregistered, ``posp`` reset) only when the free list
runs dry.  ``pages_in_use`` moves only on refcount 0 <-> 1 transitions, so
a shared page counts once.

Under a bound mesh (``mesh=``) the caches are the rank's blocks over
``model`` of ``sharding.local_cache_specs``: the kv heads (GQA ``k`` /
``v``, paged ``kp`` / ``vp``) and the mamba ``state`` heads where they
split over ``model``, every head where they do not; the slots are the
rank's own (a data rank serves its own requests, so no dim splits over
the data axes).  The host accounting is the same on every rank.

Every device write is in place, on the tensors the caches hold for the
manager's whole life (the reference rebinds its cache pytree instead): a
step captured as a CUDA graph reads and writes them, and the block table,
at the addresses it was captured at.  The device block table is refreshed
in place from the host table when an allocation, adoption, copy-on-write
or release changed it.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import TRASH_PAGE, cache_buf_len
from repro_torch.serving.prefix_cache import PrefixIndex


def _rank_caches(cfg: ModelConfig, mesh, device, **kw):
    """``models.init_caches(cfg, **kw)`` on ``device``; under a mesh the
    rank's blocks over ``model`` of them (module doc), allocated at their
    own shapes: the whole caches are laid out on the ``meta`` device only,
    so a card never holds more than its blocks.  Every leaf starts at
    zero but the position rows (``pos`` / ``posp``), at -1, as
    ``init_caches`` makes them."""
    if mesh is None:
        return models.init_caches(cfg, device=device, **kw)
    from repro_torch.sharding import Sharding, is_spec, local_cache_specs
    from repro_torch.tree import flatten_with_paths, unflatten
    whole = models.init_caches(cfg, device="meta", **kw)
    specs = dict(flatten_with_paths(local_cache_specs(whole, cfg, mesh),
                                    is_leaf=is_spec))
    blocks = []
    for path, t in flatten_with_paths(whole):
        spec = tuple(e if e == "model" else None for e in specs[path])
        shape = Sharding(mesh, spec).local(t).shape
        fill = -1 if path.rsplit("/", 1)[-1] in ("pos", "posp") else 0
        blocks.append(torch.full(shape, fill, dtype=t.dtype, device=device))
    return unflatten(whole, blocks)


class KVCache:
    """Owns the page pools + block tables for up to ``max_batch`` slots."""

    def __init__(self, cfg: ModelConfig, max_batch: int, max_len: int, *,
                 layout: str = "paged", page_size: int = 16,
                 num_pages: Optional[int] = None, prefix_cache: bool = False,
                 device, mesh=None):
        if layout not in ("paged", "contiguous"):
            raise ValueError(f"unknown cache layout {layout!r}")
        if prefix_cache and layout != "paged":
            raise ValueError("prefix_cache requires the paged layout")
        self.cfg = cfg
        self.layout = layout
        self.max_batch = max_batch
        self.max_len = max_len
        self.device = device
        self.s_buf = cache_buf_len(cfg, max_len)
        self.prefix_cache = prefix_cache
        if layout == "contiguous":
            self.caches = _rank_caches(cfg, mesh, device, batch=max_batch,
                                       max_len=max_len, layout="contiguous")
            self.stats = {}
            return
        self.page_size = page_size
        self.blocks_per_slot = -(-self.s_buf // page_size)
        full = max_batch * self.blocks_per_slot
        # +1 for the reserved trash page unmapped table entries point at
        # (requests the pool can never hold are rejected via fits_ever)
        self.num_pages = (num_pages if num_pages is not None else full) + 1
        self.caches = _rank_caches(cfg, mesh, device, layout="paged",
                                   page_size=page_size,
                                   num_pages=self.num_pages)
        self._free: List[int] = list(range(self.num_pages - 1, TRASH_PAGE, -1))
        self.table = np.full((max_batch, self.blocks_per_slot), TRASH_PAGE,
                             np.int32)
        self._owned: List[List[int]] = [[] for _ in range(max_batch)]
        self.ref = np.zeros(self.num_pages, np.int32)
        # rc-0 pages whose content is still indexed, oldest first: free
        # (evictable), yet reusable without recompute
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self.index = PrefixIndex(page_size) if prefix_cache else None
        #: the device table, refreshed in place (``block_tables``) when
        #: ``_table_dirty``; on the card through pinned staging
        self._table_dev = torch.from_numpy(self.table.copy()).to(device)
        self._table_dirty = False
        self._staging: Optional[torch.Tensor] = None
        self._copied = None
        self.stats = {"pages_in_use": 0, "pages_peak": 0,
                      "free_low_watermark": self.free_pages(),
                      "cache_evictions": 0, "cow_copies": 0}

    # ------------------------------------------------------------------ #
    # Capacity accounting
    # ------------------------------------------------------------------ #
    def pages_needed(self, total_tokens: int) -> int:
        """Pages for a request touching ``total_tokens`` positions (ring
        semantics cap it at one full buffer)."""
        return -(-min(total_tokens, self.s_buf) // self.page_size)

    def free_pages(self) -> int:
        """Pages a new allocation can take: the free list plus the cached
        rc-0 pages the LRU would surrender."""
        return len(self._free) + len(self._lru)

    def fits_ever(self, total_tokens: int) -> bool:
        """Could this request ever be admitted (even on an empty pool)?
        Prefix hits are ignored: cached pages can be evicted before the
        request completes."""
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

    def live_count(self, pages: Sequence[int]) -> int:
        """How many of ``pages`` are pinned live (refcount >= 1) now:
        adopting a live page costs no pool capacity, adopting an rc-0 LRU
        page costs one (the admission gate prices a hit with this)."""
        return sum(1 for p in pages if self.ref[p] > 0)

    # ------------------------------------------------------------------ #
    # Slot lifecycle
    # ------------------------------------------------------------------ #
    def allocate(self, slot: int, total_tokens: int = 0, *,
                 shared: Sequence[int] = (), keep_below: int = 0) -> bool:
        """Reserve pages covering positions [0, total_tokens); False (pool
        untouched) if the pool cannot.  A contiguous slot row is always
        free for its whole lifetime: its positions are cleared.

        ``shared`` maps already computed prefix pages into the slot's
        leading table columns (refcount +1 each) before fresh pages are
        taken.  ``keep_below`` is how many leading positions their content
        covers: if it ends mid-page, the boundary page is first copied into
        a private page (copy-on-write) with the positions >= ``keep_below``
        masked to -1, so the chunk that recomputes them never sees a
        position both in the pre-write cache and in the chunk.  A failed
        reservation rolls back every page taken or adopted."""
        if self.layout != "paged":
            self._clear_slot(slot)
            return True
        assert not self._owned[slot], f"slot {slot} already allocated"
        if shared:
            assert self.prefix_cache, "shared pages need prefix_cache=True"
            self._adopt(slot, list(shared))
            if keep_below < len(shared) * self.page_size:
                if not self._cow_boundary(slot, keep_below):
                    self.release(slot)
                    return False
        if not self._take(slot, self.pages_needed(total_tokens)
                          - len(self._owned[slot])):
            if self._owned[slot]:
                self.release(slot)
            return False
        return True

    def allocate_append(self, slot: int, total_tokens: int) -> bool:
        """Grow an allocated slot to cover positions [0, total_tokens); a
        no-op until the sequence crosses a page boundary.  False (slot and
        pool untouched) on a shortfall, so the engine can preempt a victim
        and retry."""
        assert self._owned[slot], f"slot {slot} has no allocation to grow"
        return self._take(slot, self.pages_needed(total_tokens)
                          - len(self._owned[slot]))

    def _pop_pages(self, need: int) -> Optional[List[int]]:
        """Pop ``need`` reusable pages: the free list first, then LRU
        eviction (oldest cached page: unregistered, ``posp`` reset).  All
        or nothing: on a shortfall every popped page returns to the free
        list (an evicted one has lost its index entry; free_pages() is
        unchanged)."""
        pages: List[int] = []
        evicted: List[int] = []
        while len(pages) < need and self._free:
            pages.append(self._free.pop())
        while len(pages) < need and self._lru:
            page, _ = self._lru.popitem(last=False)
            self.index.unregister(page)
            self.stats["cache_evictions"] += 1
            evicted.append(page)
            pages.append(page)
        if evicted:
            self._reset_pages(evicted)
        if len(pages) < need:
            self._free.extend(reversed(pages[:len(pages) - len(evicted)]))
            self._free.extend(evicted)
            return None
        return pages

    def _take(self, slot: int, need: int) -> bool:
        """Append ``need`` private pages to ``slot`` (all or nothing)."""
        if need <= 0:
            return True
        pages = self._pop_pages(need)
        if pages is None:
            return False
        for p in pages:
            self.ref[p] = 1
        have = len(self._owned[slot])
        self._owned[slot].extend(pages)
        self.table[slot, have:have + need] = pages
        self._table_dirty = True
        self.stats["pages_in_use"] += need
        self._note_levels()
        return True

    def _adopt(self, slot: int, shared: List[int]) -> None:
        """Map shared prefix pages into ``slot``'s leading table columns,
        refcount +1 each; an rc-0 page parked in the LRU is pinned live
        again, its content reused without recompute."""
        for p in shared:
            if self.ref[p] == 0:
                self._lru.pop(p)
                self.stats["pages_in_use"] += 1
            self.ref[p] += 1
        have = len(self._owned[slot])
        self._owned[slot].extend(shared)
        self.table[slot, have:have + len(shared)] = shared
        self._table_dirty = True
        self._note_levels()

    def _cow_boundary(self, slot: int, keep_below: int) -> bool:
        """Copy-on-write the slot's last adopted page into a private page
        (device copy, ``posp`` >= ``keep_below`` masked to -1); the source
        keeps its other owners, or parks in the LRU if this adoption was
        its only pin."""
        got = self._pop_pages(1)
        if got is None:
            return False
        dst = got[0]
        j = len(self._owned[slot]) - 1
        src = self._owned[slot][j]
        self._copy_page(src, dst, keep_below)
        self.ref[dst] = 1
        self.stats["pages_in_use"] += 1
        self.stats["cow_copies"] += 1
        self._owned[slot][j] = dst
        self.table[slot, j] = dst
        self._table_dirty = True
        self._drop_ref(src, batch=None)
        self._note_levels()
        return True

    def _drop_ref(self, page: int, batch: Optional[List[int]]) -> None:
        """Refcount -1; on 1 -> 0 the page leaves the live set: an indexed
        page parks (content intact) at the young end of the LRU, any other
        is reset and freed (appended to ``batch`` when the caller batches
        the device reset)."""
        self.ref[page] -= 1
        assert self.ref[page] >= 0, f"page {page} over-released"
        if self.ref[page] > 0:
            return
        self.stats["pages_in_use"] -= 1
        if self.index is not None and self.index.is_indexed(page):
            self._lru[page] = None
        elif batch is not None:
            batch.append(page)
        else:
            self._reset_pages([page])
            self._free.append(page)

    def release(self, slot: int) -> None:
        """Return a slot's pages to the pool (paged) or clear the slot
        row's positions (contiguous).  A shared page only drops a
        refcount; the last owner's release parks indexed pages in the LRU
        and resets and frees the rest."""
        if self.layout != "paged":
            self._clear_slot(slot)
            return
        pages = self._owned[slot]
        if not pages:
            return
        dead: List[int] = []
        for p in pages:
            self._drop_ref(p, batch=dead)
        if dead:
            self._reset_pages(dead)
            self._free.extend(reversed(dead))
        self._owned[slot] = []
        self.table[slot] = TRASH_PAGE
        self._table_dirty = True

    def slot_pages(self, slot: int) -> List[int]:
        """The physical pages backing ``slot``, in block order."""
        return self._owned[slot]

    def assert_private(self, slot: int, lo: int, hi: int) -> None:
        """Before a write: every page covering positions [lo, hi) of
        ``slot`` must be exclusively owned (refcount 1)."""
        if self.layout != "paged" or hi <= lo:
            return
        for j in {(p % self.s_buf) // self.page_size for p in range(lo, hi)}:
            p = self._owned[slot][j]
            assert self.ref[p] == 1, \
                f"write into shared page {p} (rc={self.ref[p]}) slot {slot}"

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

    def _note_levels(self) -> None:
        self.stats["pages_peak"] = max(self.stats["pages_peak"],
                                       self.stats["pages_in_use"])
        self.stats["free_low_watermark"] = min(
            self.stats["free_low_watermark"], self.free_pages())

    # ------------------------------------------------------------------ #
    # Prefix cache index
    # ------------------------------------------------------------------ #
    def match_prefix(self, salt: Tuple, tokens,
                     max_tokens: int) -> Tuple[List[int], int, int]:
        """Longest reusable cached prefix of ``tokens`` under ``salt`` ->
        ``(pages, hit_len, chain)``: the pages to adopt
        (``ceil(hit_len / page_size)``; the last is the copy-on-write
        boundary when ``hit_len`` ends mid-page), how many leading
        positions they cover (capped at ``max_tokens``), and the chain id
        after the last fully reused page, which the owner's next full page
        registers under."""
        if self.index is None:
            return [], 0, 0
        pages, chains = self.index.match(salt, tokens)
        hit = min(len(pages) * self.page_size, max_tokens)
        if hit <= 0:
            return [], 0, self.index.root(salt)
        keep = -(-hit // self.page_size)
        full = hit // self.page_size
        chain = chains[full - 1] if full else self.index.root(salt)
        return pages[:keep], hit, chain

    def register_page(self, chain: int, tokens, page: int) -> int:
        """Index slot-private page ``page`` as holding ``tokens`` after
        prefix ``chain``; returns the chain id after it (first wins: a
        duplicate keeps the existing entry and this page stays private)."""
        assert self.ref[page] == 1, f"registering shared page {page}"
        return self.index.register(chain, tokens, page)

    def prefix_root(self, salt: Tuple) -> int:
        """Chain id of the empty prefix under ``salt``."""
        return self.index.root(salt) if self.index is not None else 0

    # ------------------------------------------------------------------ #
    # Device-side hygiene, in place
    # ------------------------------------------------------------------ #
    def _reset_pages(self, pages: List[int]) -> None:
        """posp = -1 on recycled pages so stale entries can't pass the mask."""
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        for layer in self.caches:
            layer["posp"][idx] = -1

    def _copy_page(self, src: int, dst: int, keep_below: int) -> None:
        """Copy page ``src`` into ``dst`` in every paged leaf of every
        layer (``kp`` / ``vp`` / ``posp``, or ``ckvp`` / ``kropep`` /
        ``posp``), with ``posp`` entries >= ``keep_below`` masked to -1
        (the K/V bytes past the boundary are copied but dead until
        rewritten)."""
        for layer in self.caches:
            for name, leaf in layer.items():
                if name == "posp":
                    row = leaf[src]
                    leaf[dst] = torch.where(row < keep_below, row, -1)
                else:
                    leaf[dst] = leaf[src]

    def _clear_slot(self, slot: int) -> None:
        """pos = -1 on a slot row (the k / v bytes are masked by it); a
        mamba layer's conv and state rows to zero."""
        for layer in self.caches:
            if "pos" in layer:
                layer["pos"][slot] = -1
            else:
                layer["conv"][slot] = 0
                layer["state"][slot] = 0
