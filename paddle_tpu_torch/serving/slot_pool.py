"""SlotPool — host-side bookkeeping for the engine's decode lanes.

The port's own copy of ``paddle_tpu/serving/slot_pool.py`` (pure Python: the
port imports nothing of the JAX package), without the prefix cache's
``cached`` slot state, which this slice does not port.

The engine runs one batched decode step over ``max_slots`` lanes (plus a
scratch lane); this class owns the *index* side of that arrangement: which
lane belongs to which request, which are free, and how often lanes get
reused across requests (the continuous-batching property — lanes are
recycled, not reallocated).  The K/V bytes behind a lane are tracked by
the sibling :class:`~paddle_tpu_torch.serving.paged_kv.PageAllocator`.
Purely host-side and engine-lock-protected by the caller; no device
tensors live here.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Dict, Optional

__all__ = ["SlotPool"]


class SlotPool:
    """Fixed pool of `max_slots` decode lanes with alloc/free/reuse
    accounting.  ``alloc`` returns None when exhausted (the engine leaves
    the request queued); ``free`` returns the evicted owner."""

    def __init__(self, max_slots: int):
        if int(max_slots) < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.max_slots = int(max_slots)
        self._free: deque = deque(range(self.max_slots))
        self._owner: Dict[int, Any] = {}
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

    def active(self) -> Dict[int, Any]:
        """{slot: owner} snapshot of the allocated slots."""
        return dict(self._owner)

    @property
    def n_active(self) -> int:
        return len(self._owner)

    @property
    def n_free(self) -> int:
        return len(self._free)

    def __repr__(self):
        return (f"SlotPool(max_slots={self.max_slots}, "
                f"active={self.n_active}, allocs={self.alloc_total}, "
                f"reuses={self.reuse_total})")
