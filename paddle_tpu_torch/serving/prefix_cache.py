"""PrefixIndex — content-addressed index of KV rows resident in the pool.

The port's own copy of ``paddle_tpu/serving/prefix_cache.py`` (pure
Python: the port imports nothing of the JAX package).

Real serving traffic is dominated by requests that share a long common
prefix (the system prompt).  Without this index every such request pays
a full prefill — recomputing K/V for tokens whose cache rows are already
sitting in HBM from the previous request.  The index makes those rows
*addressable by content*: when a request completes, its slot row (which
holds the K/V of ``prompt + generated[:-1]``) is RETAINED instead of
freed; a later request whose prompt starts with a prefix of those tokens
copies the row and prefills only the tail.

Design (host-side only; the engine lock guards every call):

* **Block-aligned content addressing.**  Causality makes the first ``m``
  KV rows of a cached sequence valid for ANY request whose prompt starts
  with those ``m`` tokens — so an entry is useful at every prefix
  length, not just its full content.  Hashing every prefix would cost
  O(n²); instead each entry registers under its prefixes at **block
  boundaries** (``block`` tokens, default 16 — the vLLM block-hash
  arrangement): a dict keyed by the token tuple is the hash table, the
  tuple itself the collision check.  Lookup probes the prompt's block
  boundaries longest-first and returns ``(entry, matched_len)`` —
  O(prompt/block) probes.  The match is capped at ``len(prompt) - 1``:
  the last prompt position is always (re)prefilled because its forward
  produces the first-token logits.
* **Refcounts.**  A hit pins the source entry (``refs += 1``) for the
  lifetime of the hitting request; the eviction sweep only reclaims
  entries with ``refs == 0``, so a row being used as a copy source for
  in-flight work can never be pulled out from under it.
* **LRU eviction.**  Cached rows occupy pool slots.  When admission
  needs slots and the free list is short, the engine asks the index to
  release its least-recently-used unreferenced entries back to the free
  list — cache capacity is exactly the pool slack, no second buffer.

The index belongs to one Engine build: a supervisor rebuild constructs a
fresh engine (new pools, new index), so a crashed build's rows are
dropped wholesale — there is no path by which a stale row survives into
the rebuilt pool (chaos-asserted).
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

__all__ = ["PrefixEntry", "PrefixIndex"]


class PrefixEntry:
    """One resident cached prefix.  Dense pool: ``slot`` is the pool row
    caching the K/V of ``tokens`` (``pages`` is None).  Paged pool
    (``Engine(paged_kv=True)``): ``pages`` is the ordered physical page
    list backing those tokens and ``slot`` is None — a cached prefix
    holds pages, not a slot lane, so caching never costs decode
    capacity and a hit shares the pages by reference (COW).  ``ns`` is
    the entry's namespace (the serving engine keys entries by
    ``(adapter, tokens)`` — two adapters' identical prompts produce
    DIFFERENT K/V, so tenants never share cache rows across adapters)."""

    __slots__ = ("slot", "tokens", "refs", "tick", "keys", "pages", "ns")

    def __init__(self, slot: Optional[int], tokens: Tuple[int, ...],
                 tick: int, pages: Optional[List[int]] = None, ns=None):
        self.slot = slot
        self.tokens = tokens
        self.refs = 0
        self.tick = tick          # LRU clock: touched on insert and hit
        self.keys: List[Tuple] = []             # registered prefix keys
        self.pages = pages        # paged mode: physical pages, in order
        self.ns = ns              # namespace: (ns, tokens) is the identity

    @property
    def n(self) -> int:
        return len(self.tokens)

    def __repr__(self):
        return (f"PrefixEntry(slot={self.slot}, n={self.n}, "
                f"refs={self.refs})")


class PrefixIndex:
    """Content-addressed prefix → resident-slot map with refcounts + LRU.

    Purely host-side bookkeeping (like SlotPool); the caller holds the
    engine lock.  No device arrays live here — the entry's ``slot`` is
    the pointer into the engine's pool buffers.
    """

    def __init__(self, block: int = 16):
        if int(block) < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        self.block = int(block)
        self._entries: Dict[Tuple, PrefixEntry] = {}     # (ns, tokens)
        self._by_prefix: Dict[Tuple, PrefixEntry] = {}   # (ns, prefix)
        self._by_slot: Dict[int, PrefixEntry] = {}
        self._clock = itertools.count(1)
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def n_evictable(self) -> int:
        return sum(1 for e in self._entries.values() if e.refs == 0)

    @property
    def n_cached_tokens(self) -> int:
        """Tokens whose KV rows the index keeps resident — the content
        behind the HBM-ledger ``prefix_cache`` sub-owner's bytes."""
        return sum(e.n for e in self._entries.values())

    def _boundaries(self, n: int):
        """Block boundaries <= n, longest first (never 0)."""
        b = (n // self.block) * self.block
        while b >= self.block:
            yield b
            b -= self.block

    def lookup(self, prompt, peek: bool = False,
               ns=None) -> Optional[Tuple[PrefixEntry, int]]:
        """Longest block-aligned cached prefix of ``prompt`` (capped at
        ``len(prompt) - 1``; the last prompt token is always re-prefilled:
        its forward yields the first-token logits).  Returns
        ``(entry, matched_len)`` — the first ``matched_len`` KV rows of
        ``entry.slot`` are exactly the K/V of ``prompt[:matched_len]``.
        Counts a hit/miss and touches the LRU clock; the caller must
        :meth:`acquire` the entry if it uses it.  ``peek=True`` probes
        without counting or touching — the engine uses it to find which
        entries an incoming admission wave would hit, so the eviction
        sweep can spare them.  ``ns`` scopes the probe: only entries
        inserted under the same namespace can match."""
        toks = tuple(int(t) for t in prompt)
        for m in self._boundaries(len(toks) - 1):
            entry = self._by_prefix.get((ns, toks[:m]))
            if entry is not None:
                if not peek:
                    entry.tick = next(self._clock)
                    self.hits += 1
                return entry, m
        if not peek:
            self.misses += 1
        return None

    def insert(self, slot: Optional[int], tokens,
               pages: Optional[List[int]] = None,
               ns=None) -> Optional[PrefixEntry]:
        """Retain ``slot`` (dense) or ``pages`` (paged) as the resident
        K/V for ``tokens`` under namespace ``ns``, registering it under
        every block-boundary prefix.  Returns the new entry, or None
        when nothing would become addressable (duplicate content in the
        same namespace, or shorter than one block) — the caller then
        frees the slot/pages normally instead of retaining a useless
        row."""
        key = tuple(int(t) for t in tokens)
        if len(key) < self.block or (ns, key) in self._entries:
            return None
        entry = PrefixEntry(slot, key, next(self._clock), pages=pages,
                            ns=ns)
        self._entries[(ns, key)] = entry
        if slot is not None:
            self._by_slot[slot] = entry
        for m in self._boundaries(len(key)):
            pk = (ns, key[:m])
            # newest entry wins a shared prefix key: recency is the
            # better eviction survivor, and any matching row is correct
            self._by_prefix[pk] = entry
            entry.keys.append(pk)
        return entry

    def touch(self, entry: PrefixEntry):
        """Count a hit that was resolved earlier via ``lookup(peek=True)``
        under the same lock hold (the paged admission loop peeks first to
        size the page reservation, then commits)."""
        entry.tick = next(self._clock)
        self.hits += 1

    def miss(self):
        """Count a miss resolved via a peek (see :meth:`touch`)."""
        self.misses += 1

    def acquire(self, entry: PrefixEntry):
        entry.refs += 1

    def release(self, entry: PrefixEntry):
        if entry.refs > 0:
            entry.refs -= 1

    def _unlink(self, entry: PrefixEntry):
        del self._entries[(entry.ns, entry.tokens)]
        if entry.slot is not None:
            del self._by_slot[entry.slot]
        for pk in entry.keys:
            if self._by_prefix.get(pk) is entry:
                del self._by_prefix[pk]

    def evict_lru(self, want: int, protect=()) -> List[PrefixEntry]:
        """Drop up to ``want`` least-recently-used entries with
        ``refs == 0`` (referenced rows are copy sources for in-flight
        requests and survive every sweep; so do entries whose ``id`` is
        in ``protect`` — the ones the admission wave being made room for
        is about to hit).  Returns the dropped entries; the caller
        returns their slots to the pool's free list."""
        victims = sorted((e for e in self._entries.values()
                          if e.refs == 0 and id(e) not in protect),
                         key=lambda e: e.tick)[:want]
        for e in victims:
            self._unlink(e)
            self.evictions += 1
        return victims

    def entry_for_slot(self, slot: int) -> Optional[PrefixEntry]:
        return self._by_slot.get(slot)

    def drop_all(self) -> List[PrefixEntry]:
        """Forget every entry (engine shutdown/death); refcounts included
        — the pool the slots point into is going away."""
        out = list(self._entries.values())
        self._entries.clear()
        self._by_prefix.clear()
        self._by_slot.clear()
        return out

    def stats(self) -> dict:
        return {"entries": len(self._entries),
                "evictable": self.n_evictable,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}

    def __repr__(self):
        return (f"PrefixIndex(block={self.block}, "
                f"entries={len(self._entries)}, hits={self.hits}, "
                f"misses={self.misses}, evictions={self.evictions})")
