"""Host-memory prefix tier: evicted KV pages demote instead of dying.

The port's counterpart of ``paddle_tpu/serving/kv_tier.py``.  The device
prefix index is bounded by the page pool: when admission runs short of
pages, ``evict_lru`` frees refs-0 entries and a returning conversation
would pay a full re-prefill.  This tier keeps them in host memory:

* **demote**: the engine gathers a victim entry's pages into fresh device
  tensors on its stream (``index_select``) and hands them to
  :meth:`HostPrefixTier.demote_async`, which records an event on that
  stream and queues them.  A spill worker thread places the entry in the
  tier's host slab, has a side stream wait for the event and copy into it
  (``non_blocking``), waits for the copy (the engine's scheduler never
  does) and commits the entry; it holds the gathered tensors until then,
  so their memory is not reused under the copy.  int8 payloads and f32
  scale sidecars are kept byte for byte.
* **promote**: a lookup that misses the device index but hits this tier
  uploads the pages into freshly allocated device pages (the engine's
  ``_flush_promotes``), and the request proceeds as an ordinary hit.
* **survival**: entries are keyed by ``(ns, tokens)`` as in the device
  index and hold host memory only, so a tier handed to every build of a
  supervisor (``Engine(host_prefix=tier)``) outlives each engine; one
  engine may own its own (``Engine(host_prefix_mb=N)``).

**The slab.**  All payloads live in one host buffer of ``capacity_mb``,
pinned when a card is present, allocated when the tier is built.  Pinning
memory stalls every other thread's CUDA calls for as long as it takes
(``tools/pin_stall.py``: a 600 MB pin held another thread's launches for
234.7 ms on an H100 80GB HBM3 host, 700 W), so nothing is pinned while
serving.  An entry takes one contiguous range (first fit); when none
fits, refs-0 entries are dropped LRU-first until one does, and a demote
that still does not fit is dropped.  A promote's
upload may still be reading a range when its entry is released: the
engine passes an event recorded after the upload, and the spill worker
waits for the events of dropped entries before it writes into the slab.

Thread safety: one lock and one condition guard all mutable state; the
spill worker drains batches under the condition and copies outside it.
The engine takes its own lock before any tier call and the tier never
calls back into the engine: the lock order is engine -> tier.
"""
from __future__ import annotations

import bisect
import itertools
import threading
import time

import numpy as np
import torch

__all__ = ["HostPrefixTier", "HostPrefixEntry"]

_ALIGN = 16          # byte alignment of each tensor in a slab range


class HostPrefixEntry:
    """One demoted prefix.  ``payload`` mirrors the engine's pool groups:
    one host tensor (a view of the tier's slab) per group per layer, each
    ``[n_pages, page_size, ...]`` in the entry's own page order (page i
    holds token block i; the device page ids are not kept: a promote
    writes into whatever pages the allocator hands out)."""

    __slots__ = ("ns", "tokens", "payload", "nbytes", "refs", "tick",
                 "keys", "span", "read")

    def __init__(self, ns, tokens, payload, nbytes, tick, span):
        self.ns = ns
        self.tokens = tuple(int(t) for t in tokens)
        self.payload = payload
        self.nbytes = int(nbytes)
        self.refs = 0
        self.tick = tick
        self.keys = []                  # (ns, prefix) keys it is under
        self.span = span                # (start, size) in the slab
        self.read = None                # event after the last upload from it

    @property
    def n(self) -> int:
        return len(self.tokens)

    @property
    def n_pages(self) -> int:
        return int(self.payload[0][0].shape[0]) if self.payload else 0


def _layout(gathered):
    """Byte offsets of the tensors in one slab range, and its size."""
    offsets, at = [], 0
    for grp in gathered:
        offs = []
        for g in grp:
            offs.append(at)
            at += -(-g.numel() * g.element_size() // _ALIGN) * _ALIGN
        offsets.append(offs)
    return offsets, at


class HostPrefixTier:
    """Capacity-bounded, refcounted, LRU host tier for KV pages.

    Mirrors the device :class:`PrefixIndex` contract (entries keyed ``(ns,
    tokens)``, registered under every block-boundary prefix, newest wins,
    LRU over refs-0 entries) but bounds bytes (``capacity_mb``)."""

    def __init__(self, capacity_mb: float = 256.0, *, block: int = 16,
                 name: str = "host_prefix"):
        if capacity_mb <= 0:
            raise ValueError("capacity_mb must be positive")
        if block < 1:
            raise ValueError("block must be >= 1")
        self.capacity_bytes = int(capacity_mb * (1 << 20))
        self.block = int(block)
        self.name = name
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._entries = {}              # (ns, tokens) -> HostPrefixEntry
        self._by_prefix = {}            # (ns, prefix) -> entry (newest wins)
        self._clock = itertools.count(1)
        self._pending = []              # queued demotes awaiting their copy
        self._busy = 0                  # drained but not yet committed
        self._worker = None
        self._stop = False
        self._closed = False
        self._bytes = 0
        self._slab = torch.empty(self.capacity_bytes, dtype=torch.uint8,
                                 pin_memory=torch.cuda.is_available())
        self._free = [(0, self.capacity_bytes)]   # (start, size), by start
        self._reads = []                # upload events of dropped entries
        self._streams = {}              # device -> the copies' side stream
        self._counts = {"demotes": 0, "drops": 0, "hits": 0, "misses": 0,
                        "demote_errors": 0, "dedup_skips": 0,
                        # device seconds of the device-to-host copies (CUDA
                        # events) and the pages they moved
                        "demote_copy_seconds": 0.0, "demoted_pages": 0}

    # -- the slab --------------------------------------------------------------

    def _take_range_locked(self, size):
        for i, (start, n) in enumerate(self._free):
            if n >= size:
                if n == size:
                    del self._free[i]
                else:
                    self._free[i] = (start + size, n - size)
                return start
        return None

    def _give_range_locked(self, start, size):
        i = bisect.bisect(self._free, (start, size))
        if i < len(self._free) and start + size == self._free[i][0]:
            size += self._free.pop(i)[1]             # merge the next range
        if i > 0 and sum(self._free[i - 1]) == start:
            i -= 1
            prev_start, prev_size = self._free.pop(i)
            start, size = prev_start, prev_size + size
        self._free.insert(i, (start, size))

    def _reserve_locked(self, size):
        """A slab range of ``size`` bytes, dropping refs-0 entries
        LRU-first until one fits; None when nothing more can go."""
        while True:
            start = self._take_range_locked(size)
            if start is not None:
                return start
            victims = [(e.tick, key) for key, e in self._entries.items()
                       if e.refs == 0]
            if not victims:
                return None
            key = min(victims)[1]
            self._drop_locked(key, self._entries[key])
            self._counts["drops"] += 1

    # -- demote side (engine scheduler thread -> spill worker) ----------------

    def demote_async(self, ns, tokens, gathered) -> bool:
        """Queue one evicted entry for the host.  ``gathered`` holds fresh
        tensors (one per pool group per layer, ``[n_pages, page_size,
        ...]``) that nothing else writes, made on the caller's stream; on
        the card an event recorded there after them is all this call adds
        to that stream.  The spill worker copies and commits.  Returns
        whether the entry was queued."""
        if len(tokens) < self.block or not gathered:
            return False
        tokens = tuple(int(t) for t in tokens)
        ready = None
        if gathered[0][0].device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        with self._cv:
            if self._closed or self._stop:
                return False
            if (ns, tokens) in self._entries:
                self._counts["dedup_skips"] += 1
                return False
            self._pending.append((ns, tokens, gathered, ready))
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._spill_loop, name=f"{self.name}-spill",
                    daemon=True)
                self._worker.start()
            self._cv.notify()
        return True

    def _copy_to_host(self, gathered, ready, start):
        """Copy ``gathered`` into the slab range at ``start``: ``(payload
        views, device seconds of the copy)``.  On the card a side stream
        waits for ``ready`` and copies; this thread waits for the copy."""
        offsets, _ = _layout(gathered)
        payload = [[self._slab[start + off:start + off + g.numel() *
                               g.element_size()].view(g.dtype).view(g.shape)
                    for off, g in zip(offs, grp)]
                   for offs, grp in zip(offsets, gathered)]
        pairs = [(h, g) for host_grp, grp in zip(payload, gathered)
                 for h, g in zip(host_grp, grp)]
        if ready is None:
            for h, g in pairs:
                h.copy_(g)
            return payload, 0.0
        dev = gathered[0][0].device
        side = self._streams.get(dev)
        if side is None:
            side = self._streams[dev] = torch.cuda.Stream(dev)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        with torch.cuda.device(dev), torch.cuda.stream(side):
            side.wait_event(ready)
            t0.record()
            for h, g in pairs:
                h.copy_(g, non_blocking=True)
            t1.record()
        t1.synchronize()
        return payload, 1e-3 * t0.elapsed_time(t1)

    def _spill_loop(self):
        while True:
            with self._cv:
                while not self._pending and not self._stop:
                    self._cv.wait()
                batch, self._pending = self._pending, []
                self._busy += len(batch)
                stop = self._stop
            for ns, tokens, gathered, ready in batch:
                size = _layout(gathered)[1]
                reads = []
                with self._cv:
                    start = (None if self._closed else
                             self._reserve_locked(size))
                    if start is not None:
                        reads, self._reads = self._reads, []
                    elif not self._closed:
                        self._counts["drops"] += 1    # nothing fits
                item = None
                if start is not None:
                    try:
                        # the slab may still feed uploads of dropped entries
                        for ev in reads:
                            ev.synchronize()
                        item = self._copy_to_host(gathered, ready, start)
                    except RuntimeError:   # the device failed mid-copy
                        pass
                with self._cv:
                    if start is not None and not self._closed:
                        if item is None:
                            self._counts["demote_errors"] += 1
                            self._give_range_locked(start, size)
                        else:
                            self._commit_locked(ns, tokens, *item, start,
                                                size)
                    self._busy -= 1
                    self._cv.notify_all()
            # the gathered device tensors go only now, after their copies
            batch = gathered = None
            if stop:
                return

    def _commit_locked(self, ns, tokens, payload, secs, start, size):
        if (ns, tokens) in self._entries:
            self._counts["dedup_skips"] += 1
            self._give_range_locked(start, size)
            return
        nbytes = sum(a.numel() * a.element_size() for grp in payload
                     for a in grp)
        e = HostPrefixEntry(ns, tokens, payload, nbytes, next(self._clock),
                            (start, size))
        self._entries[(ns, tokens)] = e
        for b in self._boundaries(e.n):
            key = (ns, tokens[:b])
            self._by_prefix[key] = e          # newest wins
            e.keys.append(key)
        self._bytes += e.nbytes
        self._counts["demotes"] += 1
        self._counts["demote_copy_seconds"] += secs
        self._counts["demoted_pages"] += e.n_pages

    def _drop_locked(self, key, e):
        del self._entries[key]
        for k in e.keys:
            if self._by_prefix.get(k) is e:
                del self._by_prefix[k]
        e.keys = []
        e.payload = None
        self._bytes -= e.nbytes
        if not self._closed:
            self._give_range_locked(*e.span)
            if e.read is not None:
                self._reads.append(e.read)

    # -- lookup / promote side (engine scheduler thread) ----------------------

    def _boundaries(self, n: int):
        b = (n // self.block) * self.block
        while b >= self.block:
            yield b
            b -= self.block

    def lookup(self, prompt, *, ns=None, peek: bool = False):
        """Longest-boundary host match for ``prompt`` under ``ns``:
        ``(entry, matched)`` or None.  The match is capped at
        ``len(prompt) - 1`` (one tail token always prefills).  ``peek``
        skips the LRU touch and the counters."""
        toks = tuple(int(t) for t in np.asarray(prompt).reshape(-1))
        cap = len(toks) - 1
        for b in self._boundaries(min(len(toks), cap)):
            with self._lock:
                e = self._by_prefix.get((ns, toks[:b]))
                if e is None or e.payload is None:
                    continue
                if e.tokens[:b] == toks[:b]:
                    if not peek:
                        e.tick = next(self._clock)
                        self._counts["hits"] += 1
                    return e, b
        if not peek:
            with self._lock:
                self._counts["misses"] += 1
        return None

    def miss(self):
        """Count a miss found earlier by ``lookup(peek=True)``."""
        with self._lock:
            self._counts["misses"] += 1

    def touch(self, e: HostPrefixEntry):
        """Count a hit found earlier by ``lookup(peek=True)``."""
        with self._lock:
            e.tick = next(self._clock)
            self._counts["hits"] += 1

    def acquire(self, e: HostPrefixEntry):
        with self._lock:
            e.refs += 1

    def release(self, e: HostPrefixEntry, read=None):
        """Drop one reference; ``read`` is an event recorded after an
        upload from the entry's payload (its range is not rewritten before
        the event completes)."""
        with self._lock:
            if e.refs <= 0:
                raise KeyError("release of a host-tier entry with no refs")
            e.refs -= 1
            if read is not None:
                e.read = read

    def payload(self, e: HostPrefixEntry, n_pages: int):
        """The first ``n_pages`` pages of the entry's host payload, per
        pool group per layer (what a promote uploads)."""
        with self._lock:
            if e.payload is None:
                raise KeyError("host-tier entry was dropped")
            return [[a[:n_pages] for a in grp] for grp in e.payload]

    # -- lifecycle / accounting ----------------------------------------------

    def flush(self, timeout: float | None = 5.0) -> bool:
        """Block until every queued demote has committed (False on
        timeout)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._pending or self._busy:
                self._cv.notify()
                if deadline is None:
                    self._cv.wait(0.25)
                else:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        return False
                    self._cv.wait(min(left, 0.25))
        return True

    def drop_all(self) -> int:
        """Drop every refs-0 entry."""
        dropped = 0
        with self._lock:
            for key, e in list(self._entries.items()):
                if e.refs == 0:
                    self._drop_locked(key, e)
                    dropped += 1
        return dropped

    def close(self, timeout: float | None = 5.0):
        """Stop the spill worker, drop every entry (referenced ones too: a
        closed tier serves nothing) and free the slab.  Idempotent."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._stop = True
            self._cv.notify_all()
            worker = self._worker
        if worker is not None and worker.is_alive():
            worker.join(timeout=timeout)
        with self._lock:
            for key, e in list(self._entries.items()):
                self._drop_locked(key, e)
            self._pending = []
            self._reads = []
            self._free = []
            self._slab = None

    def check(self):
        """Invariants (tests): the byte count is consistent, no negative
        refs, every prefix key points at a live entry, and the slab's free
        and used ranges cover it once."""
        with self._lock:
            total = sum(e.nbytes for e in self._entries.values())
            if total != self._bytes:
                raise AssertionError(
                    f"host tier byte leak: sum={total} count={self._bytes}")
            for e in self._entries.values():
                if e.refs < 0:
                    raise AssertionError(f"negative refs on {e.tokens[:4]}")
            for key, e in self._by_prefix.items():
                if self._entries.get((e.ns, e.tokens)) is not e:
                    raise AssertionError(f"dangling host prefix key {key!r}")
            if not self._closed and not self._busy:
                at = 0
                for start, size in sorted(self._free + [
                        e.span for e in self._entries.values()]):
                    if start != at:
                        raise AssertionError(
                            f"slab ranges overlap or leak at byte {at}")
                    at += size
                if at != self.capacity_bytes:
                    raise AssertionError(f"slab ranges end at byte {at}")

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "capacity_bytes": self.capacity_bytes,
                    "pending": len(self._pending) + self._busy,
                    **dict(self._counts)}
