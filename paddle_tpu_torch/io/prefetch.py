"""DevicePrefetcher — the overlapped input pipeline (the port's copy of
``paddle_tpu/io/prefetch.py``).

``DevicePrefetcher`` wraps a DataLoader or any iterable of host batches
and keeps up to ``depth`` batches resident on the card ahead of the
consumer: a background thread pulls host batches and copies them to the
card, so batch *k+1* is already there while step *k* runs.  On CUDA the
copy is pinned staging plus a copy stream:

* the producer thread copies each array leaf into a pinned host buffer
  and issues a ``non_blocking`` copy to the card on its own
  ``torch.cuda.Stream`` (never the legacy default stream, which would
  serialise with compute), then records an event on that stream;
* the consumer's stream waits on that event before first use of the
  batch, and every delivered tensor gets ``record_stream`` on the
  consumer's stream, so the caching allocator does not hand its memory
  out again while the consumer's work on it may still be queued;
* each leaf goes through a pinned block of torch's caching host
  allocator: the ``non_blocking`` copy records its event on the block,
  and the allocator hands the block out again only after that event has
  completed (it queries the event, it never waits on the card), so any
  leaf size works, batch to batch;
* a ``DataLoader`` hands over its host batches (``DataLoader._host_iter``)
  so the host-to-device copy happens once, on the copy stream.

On the CPU (``device="cpu"``, as the tests run it) leaves become CPU
tensors.  Leaves come back as surface ``Tensor``s in the batch's own
nesting.

Contracts (the JAX module's):

* **Bounded.**  At most ``depth`` batches sit in the buffer; the producer
  holds at most one more in flight, so the source is never more than
  ``depth + 1`` batches ahead of the consumer.
* **Clean end/err.**  Source exhaustion becomes a normal ``StopIteration``;
  a producer-side exception is re-raised in the consumer at the position
  it occurred.
* **No leaked threads.**  Dropping the iterator (``break``, GC) or calling
  ``close()`` stops the producer; its enqueue loop polls a stop event, so
  it can never block forever on a full buffer.
* **No device sync when warm.**  A warm buffer costs one
  ``Queue.get_nowait``, one ``wait_event`` and a ``record_stream`` per
  leaf — nothing that waits for the card.

``mesh=`` (and ``stacked=`` with a mesh) raise ``NotImplementedError``:
meshes are ROADMAP module item 11; ``stacked=True`` without a mesh yields
the ``[K, B, ...]`` stacks ``ShardedTrainStep.run_steps`` takes.

Telemetry: the always-on flight recorder gets a ``pipeline_stall`` event
whenever the consumer finds the buffer empty after warmup (the card is
about to wait on the host); with telemetry on the metrics registry also
carries the buffer-occupancy gauge and the ``host_input_wait_seconds``
counter (``observability/steps.py``).  ``stats()`` gives the same numbers
as plain floats.
"""
from __future__ import annotations

import queue as queue_mod
import threading
import time

import numpy as np
import torch

from ..core import place as place_mod
from ..core.tensor import Tensor

# sentinel: the source is exhausted (producer -> consumer)
_END = object()


class _Failure:
    """Producer-side exception carried through the queue."""

    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


class _Batch:
    """A batch on the card, with the copy stream's event that the
    consumer's stream waits on."""

    __slots__ = ("tree", "event", "tensors", "nbytes")

    def __init__(self, tree, event, tensors):
        self.tree = tree
        self.event = event
        self.tensors = tensors
        self.nbytes = sum(t.numel() * t.element_size() for t in tensors)


def _is_array(obj) -> bool:
    return isinstance(obj, (np.ndarray, np.generic, torch.Tensor, Tensor))


def _tree_map(obj, fn):
    """``fn`` over every array leaf of a batch nest, keeping its shape."""
    if _is_array(obj):
        return fn(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_map(v, fn) for v in obj)
    if isinstance(obj, dict):
        return {k: _tree_map(v, fn) for k, v in obj.items()}
    return obj


def _host_tensor(v) -> torch.Tensor:
    if isinstance(v, Tensor):
        v = v._value
    if isinstance(v, torch.Tensor):
        return v
    v = np.asarray(v)
    if not v.flags.writeable or not v.flags.c_contiguous:
        v = np.ascontiguousarray(v).copy()
    return torch.from_numpy(v)


class _PrefetchIter:
    """One epoch: a producer thread + a bounded queue.  Created fresh per
    ``iter(DevicePrefetcher)`` so epoch loops restart the pipeline."""

    def __init__(self, owner: "DevicePrefetcher", source):
        self._owner = owner
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=owner.depth)
        self._stop = threading.Event()
        self._warm = False
        self._done = False
        # ledger row: device bytes sitting in this buffer (batches copied
        # but not yet consumed) declare their owner
        from ..observability import perfscope
        self._ledger = perfscope.ledger().register(
            "prefetch", 0, detail=f"DevicePrefetcher buffer ({owner.name})")
        self._thread = threading.Thread(
            target=self._produce, args=(source,), daemon=True,
            name=f"prefetch-{owner.name}")
        self._thread.start()

    # -- producer ------------------------------------------------------------
    def _produce(self, source):
        try:
            self._produce_from(source)
        finally:
            # a DataLoader's worker iterator: its workers stop with us
            shutdown = getattr(source, "_shutdown", None)
            if shutdown is not None:
                shutdown()

    def _produce_from(self, source):
        dev = self._owner.device
        try:
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    self._produce_cuda(source, dev)
            else:
                for batch in source:
                    if self._stop.is_set():
                        return
                    tensors = []

                    def put(v):
                        t = _host_tensor(v).to(dev, copy=True)
                        tensors.append(t)
                        return Tensor._wrap(t)

                    tree = _tree_map(batch, put)
                    if not self._enqueue(_Batch(tree, None, tensors)):
                        return
            self._enqueue(_END)
        except BaseException as e:  # noqa: BLE001 — re-raised consumer-side
            self._enqueue(_Failure(e))

    def _produce_cuda(self, source, dev):
        stream = torch.cuda.Stream(dev)
        for batch in source:
            if self._stop.is_set():
                return
            tensors = []

            def put(v):
                src = _host_tensor(v)
                if src.is_cuda:
                    raise RuntimeError(
                        "DevicePrefetcher takes host batches; got a CUDA "
                        "tensor")
                # a block of the caching host allocator, released with
                # ``pinned``: the copy's recorded event keeps it from reuse
                pinned = torch.empty(src.shape, dtype=src.dtype,
                                     pin_memory=True)
                pinned.copy_(src)
                with torch.cuda.stream(stream):
                    t = pinned.to(dev, non_blocking=True)
                tensors.append(t)
                return Tensor._wrap(t)

            tree = _tree_map(batch, put)
            event = torch.cuda.Event()
            event.record(stream)
            if not self._enqueue(_Batch(tree, event, tensors)):
                return

    def _enqueue(self, item) -> bool:
        # bounded put that can always be woken by close(): never block
        # indefinitely on a full buffer the consumer abandoned
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
            except queue_mod.Full:
                continue
            if isinstance(item, _Batch):
                self._ledger.add(item.nbytes)
            self._owner._note_depth(self._q.qsize())
            return True
        return False

    # -- consumer ------------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        owner = self._owner
        try:
            item = self._q.get_nowait()
        except queue_mod.Empty:
            # the train loop is about to wait on the host.  After warmup
            # that is a pipeline stall (producer slower than the card);
            # the cold first batch is expected and only counts as wait.
            stalled = self._warm
            t0 = time.perf_counter()
            item = self._blocking_get()
            owner._note_wait(time.perf_counter() - t0, stalled=stalled)
        self._warm = True
        owner._note_depth(self._q.qsize())
        if item is _END:
            self.close()
            raise StopIteration
        if isinstance(item, _Failure):
            self.close()
            raise item.exc
        self._ledger.add(-item.nbytes)
        if item.event is not None:
            cur = torch.cuda.current_stream(owner.device)
            cur.wait_event(item.event)
            for t in item.tensors:
                t.record_stream(cur)
        owner._note_batch()
        return item.tree

    def _blocking_get(self):
        while True:
            try:
                return self._q.get(timeout=1.0)
            except queue_mod.Empty:
                if not self._thread.is_alive():
                    # the Failure/_END protocol covers every normal exit;
                    # this guards against the producer dying unenqueued
                    raise RuntimeError(
                        "DevicePrefetcher producer thread died without "
                        "delivering a result")

    def close(self):
        """Stop the producer and release the buffer.  Idempotent; called on
        normal exhaustion, error, early exit and GC."""
        self._done = True
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)
        self._ledger.release()     # buffered batches die with the iterator

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class DevicePrefetcher:
    """Wrap a DataLoader/iterable; yield card-resident batches ``depth``
    ahead of the consumer (see the module docstring).

    ``device`` defaults to the current place (the card unless the caller
    set the CPU).  Re-iterable: each ``iter()`` starts a fresh producer
    over the source; ``stats()`` aggregates across epochs.
    """

    def __init__(self, data, depth: int = 2, mesh=None,
                 stacked: bool = False, name: str = "prefetch",
                 device=None):
        if mesh is not None:
            raise NotImplementedError(
                "DevicePrefetcher(mesh=...) is not ported yet: the port "
                "has the single-device step (ROADMAP module item 11)")
        self.data = data
        self.depth = max(1, int(depth))
        self.mesh = None
        self.stacked = bool(stacked)
        self.name = name
        self.device = torch.device(device) if device is not None else \
            place_mod.current_device()
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._last_iter: _PrefetchIter | None = None
        self._lock = threading.Lock()
        # plain-float stats, always on (bench reads them without telemetry)
        self.batches = 0
        self.wait_seconds = 0.0
        self.stalls = 0

    # -- iteration -----------------------------------------------------------
    def _source(self):
        from .dataloader import DataLoader
        if isinstance(self.data, DataLoader):
            return self.data._host_iter()
        return iter(self.data)

    def __iter__(self):
        obs = self._obs()
        if obs.enabled():
            # pre-register the series at 0 so an exporter can tell "no
            # wait" (healthy overlap) from "not instrumented"
            obs.steps.record_input_wait(0.0, fn=self.name)
            obs.steps.set_prefetch_depth(0, fn=self.name)
        it = _PrefetchIter(self, self._source())
        with self._lock:
            prev, self._last_iter = self._last_iter, it
        if prev is not None:
            prev.close()
        return it

    def __len__(self):
        return len(self.data)

    def close(self):
        with self._lock:
            it, self._last_iter = self._last_iter, None
        if it is not None:
            it.close()

    def stats(self) -> dict:
        # under the same lock the telemetry sinks take, so a reader
        # polling from another thread gets a consistent snapshot
        with self._lock:
            return {"batches": self.batches, "depth": self.depth,
                    "wait_seconds": self.wait_seconds,
                    "stalls": self.stalls}

    # -- telemetry sinks (called from both threads) --------------------------
    @staticmethod
    def _obs():
        from .. import observability
        return observability

    def _note_depth(self, qsize: int):
        obs = self._obs()
        if obs.enabled():
            obs.steps.set_prefetch_depth(qsize, fn=self.name)

    def _note_wait(self, seconds: float, stalled: bool):
        with self._lock:
            self.wait_seconds += seconds
            if stalled:
                self.stalls += 1
        obs = self._obs()
        if stalled:
            # always-on flight event: the card waited on the host
            obs.flight.record("pipeline_stall", self.name,
                              waited_ms=round(seconds * 1e3, 3),
                              depth=self.depth)
        if obs.enabled():
            obs.steps.record_input_wait(seconds, fn=self.name)
            if stalled:
                obs.steps.record_pipeline_stall(fn=self.name)

    def _note_batch(self):
        with self._lock:
            self.batches += 1
        obs = self._obs()
        if obs.enabled():
            obs.steps.record_prefetch_batch(fn=self.name)
