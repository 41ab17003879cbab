"""PageAllocator — host-side bookkeeping for the block-granular KV pool.

The port's own copy of ``paddle_tpu/serving/paged_kv.py`` (pure Python: the
port imports nothing of the JAX package).

The dense slot pool provisions ``[max_slots+1, max_len, ...]`` HBM rows:
every slot pays for the worst-case sequence whether or not it uses it,
and the prefix cache can only share whole rows by device copy.  The
paged pool (the vLLM PagedAttention arrangement) stores
K/V in fixed-size **pages** of ``page_size`` positions —
``[num_pages, page_size, heads, head_dim]`` per layer — and each slot
carries an int32 **page table** mapping its virtual positions onto
physical pages.  HBM then scales with the tokens actually resident:

* short requests hold few pages, so a heavy-tail traffic mix fits many
  more concurrent sequences in the same bytes;
* a sequence grows past the dense pool's compiled ``max_len`` by simply
  owning more table entries (the decode program's shapes depend on
  ``num_pages`` and the table width, not on a per-slot row length);
* a prefix-cache hit shares the cached pages **by reference** —
  refcount++ per page instead of a bitwise device row copy — with
  copy-on-write when a writer's frontier lands inside a shared page.

This class owns the *index* side only: the free list and per-page
refcounts.  Purely host-side and engine-lock-protected by the caller;
no device arrays live here (the page id is the pointer into the
engine's pool buffers).  Pages are refcounted because one physical page
can back several readers at once — a prefix-cache entry plus any number
of in-flight requests that hit on it; a page returns to the free list
only when its last reference is dropped.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

__all__ = ["PageAllocator"]


class PageAllocator:
    """Fixed pool of ``num_pages`` KV pages with refcounted alloc/free.

    ``alloc(n)`` is all-or-nothing: it returns ``n`` page ids or None
    when fewer than ``n`` are free (admission leaves the request queued
    — page exhaustion is backpressure, never a partial allocation to
    unwind).  ``share`` adds a reference to a resident page (prefix
    sharing); ``deref`` drops one and frees the page at refcount 0.
    Double ``deref`` of a free page raises (the double-free guard).
    """

    def __init__(self, num_pages: int, page_size: int):
        if int(num_pages) < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        if int(page_size) < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._free: deque = deque(range(self.num_pages))
        self._refs: Dict[int, int] = {}
        self.alloc_total = 0
        self.share_total = 0
        self.free_total = 0

    # -- allocation ----------------------------------------------------------
    def alloc(self, n: int = 1) -> Optional[List[int]]:
        """Claim ``n`` pages (refcount 1 each); None when fewer than ``n``
        are free — all-or-nothing, so the caller never holds a partial
        grant it would have to unwind."""
        n = int(n)
        if n < 0:
            raise ValueError(f"cannot alloc {n} pages")
        if n > len(self._free):
            return None
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        self.alloc_total += n
        return pages

    def share(self, page: int) -> int:
        """Add a reference to a resident page (a prefix-cache hit mapping
        the page into another slot's table); returns the new refcount.
        KeyError on a page that is not allocated."""
        self._refs[page] += 1          # KeyError: page is free
        self.share_total += 1
        return self._refs[page]

    def deref(self, page: int) -> bool:
        """Drop one reference; returns True when this was the last one
        and the page went back to the free list.  KeyError on a page
        that is not allocated (double-free guard)."""
        refs = self._refs[page] - 1    # KeyError: already free
        if refs > 0:
            self._refs[page] = refs
            return False
        del self._refs[page]
        self._free.append(page)
        self.free_total += 1
        return True

    def refs(self, page: int) -> int:
        """Current refcount (0 for a free page)."""
        return self._refs.get(page, 0)

    # -- introspection -------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.num_pages - len(self._free)

    def check(self) -> None:
        """Internal-consistency assert (chaos/teardown leak check): every
        tracked page has refs >= 1, and tracked + free partitions the
        pool exactly.  Raises AssertionError on a leak or a corruption."""
        assert all(r >= 1 for r in self._refs.values()), self._refs
        assert len(self._refs) + len(self._free) == self.num_pages, (
            len(self._refs), len(self._free), self.num_pages)
        assert not (set(self._refs) & set(self._free))

    def __repr__(self):
        return (f"PageAllocator(num_pages={self.num_pages}, "
                f"page_size={self.page_size}, free={self.n_free}, "
                f"used={self.n_used}, allocs={self.alloc_total}, "
                f"shares={self.share_total})")
