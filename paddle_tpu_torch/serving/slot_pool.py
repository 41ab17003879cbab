"""SlotPool — host-side bookkeeping for the fixed KV-cache slot pool.

The port's own copy of ``paddle_tpu/serving/slot_pool.py`` (pure Python: the
port imports nothing of the JAX package).

The engine's device state is a set of fixed ``[max_slots(+1), max_len, ...]``
cache buffers; this class owns the *index* side of that arrangement: which
slot belongs to which request, which are free, and how often slots get
reused across requests (the continuous-batching property — one compiled
decode program serves a stream of requests because slots are recycled, not
reallocated).  Purely host-side and engine-lock-protected by the caller; no
device arrays live here.

Slots have three states: **free** (on the free list), **active** (owned
by an in-flight request), and **cached** (retained by the prefix cache:
the row's K/V is kept resident as a re-usable prefix instead of being
recycled immediately — see prefix_cache.PrefixIndex).  Cached slots are
invisible to ``n_active`` (an engine with only cached rows is idle) and
return to the free list through ``release_cached`` when the index evicts
them.

Under the paged pool (``Engine(paged_kv=True)``) this class still owns
the decode LANES (the batch rows of the single compiled decode
program), but the K/V bytes behind a lane are tracked by the sibling
:class:`~paddle_tpu_torch.serving.paged_kv.PageAllocator` — cached prefixes
then hold pages instead of slots, so the ``cached`` state stays empty
and caching never costs decode capacity.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Dict, Optional

__all__ = ["SlotPool"]


class SlotPool:
    """Fixed pool of `max_slots` KV-cache slots with alloc/free/reuse
    accounting.  ``alloc`` returns None when exhausted (the engine leaves
    the request queued); ``free`` returns the evicted owner."""

    def __init__(self, max_slots: int):
        if int(max_slots) < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.max_slots = int(max_slots)
        self._free: deque = deque(range(self.max_slots))
        self._owner: Dict[int, Any] = {}
        self._cached: Dict[int, Any] = {}
        self._ever_used: set = set()
        self.alloc_total = 0
        self.reuse_total = 0

    def alloc(self, owner: Any) -> Optional[int]:
        """Claim the lowest free slot for `owner`; None when the pool is
        full (admission must wait for an eviction)."""
        if not self._free:
            return None
        slot = self._free.popleft()
        self._owner[slot] = owner
        self.alloc_total += 1
        if slot in self._ever_used:
            self.reuse_total += 1
        self._ever_used.add(slot)
        return slot

    def free(self, slot: int) -> Any:
        """Evict `slot` back to the free list; returns its owner.  Raises
        KeyError on a slot that is not allocated (double-free guard)."""
        owner = self._owner.pop(slot)  # KeyError: not allocated
        self._free.append(slot)
        return owner

    def retain(self, slot: int, holder: Any) -> Any:
        """Move an ACTIVE slot to the cached state instead of freeing it:
        the row stays resident (prefix cache) but stops counting as
        active.  Returns the previous owner; KeyError on a slot that is
        not active (same double-free guard as ``free``)."""
        owner = self._owner.pop(slot)
        self._cached[slot] = holder
        return owner

    def release_cached(self, slot: int) -> Any:
        """Return a cached slot to the free list (prefix-cache eviction);
        returns the holder.  KeyError when the slot is not cached."""
        holder = self._cached.pop(slot)
        self._free.append(slot)
        return holder

    def owner(self, slot: int) -> Any:
        return self._owner[slot]

    def active(self) -> Dict[int, Any]:
        """{slot: owner} snapshot of the allocated slots."""
        return dict(self._owner)

    def cached(self) -> Dict[int, Any]:
        """{slot: holder} snapshot of the prefix-cache-retained slots."""
        return dict(self._cached)

    @property
    def n_active(self) -> int:
        return len(self._owner)

    @property
    def n_cached(self) -> int:
        return len(self._cached)

    @property
    def n_free(self) -> int:
        return len(self._free)

    def __len__(self) -> int:
        return self.n_active

    def __repr__(self):
        return (f"SlotPool(max_slots={self.max_slots}, "
                f"active={self.n_active}, cached={self.n_cached}, "
                f"allocs={self.alloc_total}, reuses={self.reuse_total})")
