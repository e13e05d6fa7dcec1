"""Prefix cache index: hash-consed full KV pages keyed by content chains.

The port's own copy of ``repro.serving.prefix_cache`` (numpy only, no
device state), kept here because the port imports nothing of the JAX
package.

The index is the host-side half of prefix caching (DESIGN.md §8).  A KV
page is reusable by a later request iff it holds *exactly* the keys and
values that request's prefill would have computed for those positions --
which is determined by (a) every token from position 0 up to the end of
the page, and (b) the serving specialization that produced it (the LExI
plan changes per-layer expert budgets, so hidden states -- and therefore
K/V -- differ between plans; likewise the expert storage dtype).

Rather than hashing, the index keys pages **exactly**: each registered
chain prefix gets an interned integer id, and a page's key is
``(parent_chain_id, page_tokens_bytes)`` with the per-``salt`` root id
folding in the plan name and any numerics-relevant ``ModelOpts``.  Two
chains collide iff they are byte-identical token-by-token from position
0, so a match can never map in a wrong page -- there is no hash-collision
failure mode to reason about.

Only **full** pages are indexed: a partially filled page is still being
written by its owner, so its content is not final.  The page-size is
therefore the sharing granularity; the copy-on-write boundary page (a
full shared page whose tail positions a new request must overwrite to
produce logits) is handled by the ``KVCache``, not here.

Lifecycle contract with ``KVCache``:

* ``register`` is called when a page fills; first-wins -- if an identical
  chain is already indexed the existing entry is kept and the caller's
  page simply stays private (it will be recycled normally on release).
* ``unregister`` is called when the pool reclaims a cached page (LRU
  eviction).  Descendant entries that chained through the evicted page
  become unreachable by ``match`` (the walk stops at the first miss) and
  age out of the pool's LRU on their own.

The index never touches device memory and holds no token *histories* --
per-entry state is one dict slot keyed by the page's token bytes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def _page_bytes(tokens) -> bytes:
    return np.ascontiguousarray(tokens, np.int32).tobytes()


class PrefixIndex:
    """Exact-content chain index: page -> (parent chain, token bytes)."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self._next_id = 1
        self._roots: Dict[Tuple, int] = {}          # salt -> root chain id
        #: (parent chain id, page token bytes) -> (chain id, page)
        self._entries: Dict[Tuple[int, bytes], Tuple[int, int]] = {}
        self._keys: Dict[int, Tuple[int, bytes]] = {}   # page -> its key

    def __len__(self) -> int:
        """Number of pages currently indexed."""
        return len(self._keys)

    def root(self, salt: Tuple) -> int:
        """Chain id of the empty prefix under ``salt`` (plan, opts...)."""
        if salt not in self._roots:
            self._roots[salt] = self._next_id
            self._next_id += 1
        return self._roots[salt]

    def match(self, salt: Tuple, tokens) -> Tuple[List[int], List[int]]:
        """Longest indexed full-page chain prefix of ``tokens``.

        Returns ``(pages, chains)`` -- the physical page per matched block
        and the chain id *after* each block (``chains[j]`` keys block
        ``j+1``'s lookup).  Only ``len(tokens) // page_size`` full pages
        are ever considered.
        """
        p = self.page_size
        chain = self.root(salt)
        tokens = np.ascontiguousarray(tokens, np.int32)
        pages: List[int] = []
        chains: List[int] = []
        for j in range(len(tokens) // p):
            ent = self._entries.get((chain, tokens[j * p:(j + 1) * p]
                                     .tobytes()))
            if ent is None:
                break
            chain, page = ent
            pages.append(page)
            chains.append(chain)
        return pages, chains

    def register(self, chain: int, tokens, page: int) -> int:
        """Index a freshly filled page; returns the chain id after it.

        First-wins: if the identical chain is already indexed, the
        existing entry's id is returned and ``page`` is NOT indexed (the
        caller's page stays an ordinary private page).  Either way the
        returned id is what the owner's *next* page registers under.
        """
        assert page not in self._keys, f"page {page} already indexed"
        key = (chain, _page_bytes(tokens))
        ent = self._entries.get(key)
        if ent is not None:
            return ent[0]
        cid = self._next_id
        self._next_id += 1
        self._entries[key] = (cid, page)
        self._keys[page] = key
        return cid

    def is_indexed(self, page: int) -> bool:
        return page in self._keys

    def unregister(self, page: int) -> None:
        """Drop a page's entry (pool reclaimed it); no-op if unindexed."""
        key = self._keys.pop(page, None)
        if key is not None:
            del self._entries[key]
