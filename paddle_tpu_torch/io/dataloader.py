"""DataLoader (reference: fluid/dataloader/dataloader_iter.py:342
_DataLoaderIterMultiProcess — worker procs + shared memory + prefetch;
fluid/reader.py facade; the port's copy of ``paddle_tpu/io/dataloader.py``).

Feeding the card is a host job.  The multiprocess path forks worker
processes (``mp.get_context("fork")``) that send numpy batches over the
shared-memory ring (``use_shared_memory=True``, ``io/shm_channel.py``) or
a pickling queue, with a prefetch depth (≈ buffered_reader.cc
double-buffering).  A forked child must never touch CUDA: workers and
``collate_fn`` produce host values only (numpy arrays or CPU tensors; a
CUDA tensor in a worker raises), and the parent places each batch once,
on the current place.  Wrapped by a ``DevicePrefetcher``
(``io/prefetch.py``), the loader hands its host batches to the
prefetcher's copy stream instead (:meth:`DataLoader._host_iter`): the
host-to-device copy happens there, never also on the main thread.
"""
from __future__ import annotations

import itertools
import multiprocessing as mp
import queue as queue_mod
import threading
import traceback

import numpy as np
import torch

from ..core import place as place_mod
from ..core.tensor import Tensor
from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler


class _WorkerInfo:
    def __init__(self, id, num_workers, dataset, seed):  # noqa: A002
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset
        self.seed = seed


_worker_info = None


def get_worker_info():
    return _worker_info


def _host_array(v):
    """A sample's tensor as a host array; a CUDA tensor inside a worker
    (a forked child) raises."""
    t = v._value if isinstance(v, Tensor) else v
    if t.is_cuda and _worker_info is not None:
        raise RuntimeError(
            "a DataLoader worker got a CUDA tensor: workers are forked and "
            "must never touch CUDA; return numpy arrays or CPU tensors from "
            "the dataset and let the parent place the batch")
    return Tensor._wrap(t).numpy()


def default_collate_fn(batch):
    sample = batch[0]
    if isinstance(sample, (np.ndarray, np.generic)):
        return np.stack(batch)
    if isinstance(sample, (Tensor, torch.Tensor)):
        return np.stack([_host_array(s) for s in batch])
    if isinstance(sample, (int, float)):
        return np.asarray(batch)
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn(list(items))
                            for items in zip(*batch))
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    return batch


def _place(v):
    """A host leaf as a Tensor on the current place (the one copy)."""
    dev = place_mod.current_device()
    if isinstance(v, Tensor):
        v = v._value
    if isinstance(v, torch.Tensor):
        return Tensor._wrap(v.to(dev))
    if not v.flags.writeable:       # a view of the shm message's bytes
        v = v.copy()
    return Tensor._wrap(torch.from_numpy(np.ascontiguousarray(v)).to(dev))


def _to_tensor_nest(obj, return_list):
    if isinstance(obj, (np.ndarray, torch.Tensor, Tensor)):
        return _place(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_tensor_nest(v, return_list) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_tensor_nest(v, return_list) for k, v in obj.items()}
    return obj


def _worker_loop(dataset, index_queue, data_queue, collate_fn, worker_id,
                 num_workers, seed, worker_init_fn=None):
    global _worker_info
    # one intra-op thread, as torch's own loader sets in its workers: a
    # worker forked after the parent ran threaded CPU ops would otherwise
    # wait forever on the parent's OpenMP pool at its first torch op (a
    # Tensor sample's host copy, ToTensor -> Normalize)
    torch.set_num_threads(1)
    _worker_info = _WorkerInfo(worker_id, num_workers, dataset, seed)
    np.random.seed((seed + worker_id) % (2 ** 32))
    if worker_init_fn is not None:
        worker_init_fn(worker_id)
    # flight-recorder spans live in THIS process's ring (fork copy): a
    # worker crash dump shows whether it died starving (get wait) or
    # blocked on a full ring (put wait)
    from ..observability import trace as _trace
    is_iterable = isinstance(dataset, IterableDataset)
    it = iter(dataset) if is_iterable else None
    while True:
        with _trace.span("dataloader.worker_get", worker=worker_id):
            task = index_queue.get()
        if task is None:
            break
        batch_id, indices = task
        try:
            if is_iterable:
                samples = list(itertools.islice(it, len(indices)))
                if not samples:
                    data_queue.put((batch_id, StopIteration(), None))
                    continue
            else:
                samples = [dataset[i] for i in indices]
            batch = collate_fn(samples)
            with _trace.span("dataloader.worker_put", worker=worker_id,
                             batch_id=batch_id):
                data_queue.put((batch_id, None, batch))
        except BrokenPipeError:  # shm ring closed by parent shutdown
            break
        except Exception:  # noqa: BLE001
            try:
                data_queue.put((batch_id,
                                RuntimeError(traceback.format_exc()), None))
            except BrokenPipeError:
                break


class _SingleProcessIter:
    def __iter__(self):
        return self

    def __init__(self, loader):
        self.loader = loader
        ds = loader.dataset
        if isinstance(ds, IterableDataset):
            self._it = iter(ds)
            self._batches = None
        else:
            self._it = None
            self._batches = iter(loader.batch_sampler)

    def __next__(self):
        loader = self.loader
        if self._it is not None:
            samples = list(itertools.islice(self._it, loader.batch_size or 1))
            if not samples:
                raise StopIteration
        else:
            indices = next(self._batches)
            samples = [loader.dataset[i] for i in indices]
        return loader.collate_fn(samples)


class _ShmDataQueue:
    """mp.Queue-compatible (put/get of (bid, err, batch)) over the native
    shared-memory ring (csrc/shm_ring.cpp): numpy batch payloads cross the
    process boundary without pickling — the reference's shared-memory tensor
    path (use_shared_memory, dataloader_iter.py)."""

    _EXC_KEY = "__pt_exc__"

    def __init__(self, capacity=64 << 20):
        from .shm_channel import ShmQueue
        self._q = ShmQueue(capacity=capacity)

    def put(self, item):
        from .shm_channel import encode_batch
        bid, err, batch = item
        if err is None:
            # encode_batch keeps the container (tuple/list/bare array) and
            # falls back to pickle for anything non-array
            self._q.put(encode_batch(bid, batch))
        else:
            self._q.put(encode_batch(bid, {self._EXC_KEY: err,
                                           "batch": batch}))

    def get(self):
        from .shm_channel import decode_batch
        bid, payload = decode_batch(self._q.get())
        if isinstance(payload, dict) and self._EXC_KEY in payload:
            return bid, payload[self._EXC_KEY], payload.get("batch")
        return bid, None, payload

    def close(self):
        self._q.close()
        self._q.free()


class _MultiProcessIter:
    def __init__(self, loader):
        self.loader = loader
        self.num_workers = loader.num_workers
        ctx = mp.get_context("fork")
        self.index_queues = [ctx.Queue() for _ in range(self.num_workers)]
        if loader.use_shared_memory:
            self.data_queue = _ShmDataQueue(
                capacity=loader.shm_ring_capacity)
        else:
            self.data_queue = ctx.Queue()
        seed = np.random.randint(0, 2 ** 31)
        self.workers = []
        for wid in range(self.num_workers):
            w = ctx.Process(
                target=_worker_loop,
                args=(loader.dataset, self.index_queues[wid], self.data_queue,
                      loader.collate_fn, wid, self.num_workers, seed,
                      loader.worker_init_fn),
                daemon=True)
            w.start()
            self.workers.append(w)
        if isinstance(loader.dataset, IterableDataset):
            bs = loader.batch_size or 1
            self._batches = iter(lambda: list(range(bs)), None)  # endless
        else:
            self._batches = iter(loader.batch_sampler)
        self._send_idx = 0
        self._recv_idx = 0
        self._reorder = {}
        self._outstanding = 0
        self._exhausted = False
        for _ in range(loader.prefetch_factor * self.num_workers):
            self._dispatch()

    def _dispatch(self):
        if self._exhausted:
            return
        try:
            indices = next(self._batches)
        except StopIteration:
            self._exhausted = True
            return
        wid = self._send_idx % self.num_workers
        self.index_queues[wid].put((self._send_idx, indices))
        self._send_idx += 1
        self._outstanding += 1

    def __next__(self):
        while True:
            if self._outstanding == 0:
                self._shutdown()
                raise StopIteration
            if self._recv_idx in self._reorder:
                err, batch = self._reorder.pop(self._recv_idx)
            else:
                # span = time the train loop starved on the workers;
                # `outstanding` is the dispatched-not-yet-received queue
                # depth the flight record needs to tell "workers slow"
                # from "queue sized wrong"
                from ..observability import trace as _trace
                with _trace.span("dataloader.get", batch_id=self._recv_idx,
                                 outstanding=self._outstanding,
                                 reordered=len(self._reorder)):
                    bid, err, batch = self.data_queue.get()
                if bid != self._recv_idx:
                    self._reorder[bid] = (err, batch)
                    continue
            self._recv_idx += 1
            self._outstanding -= 1
            self._dispatch()
            if isinstance(err, StopIteration):
                self._exhausted = True
                continue
            if err is not None:
                self._shutdown()
                raise err
            if isinstance(self.data_queue, _ShmDataQueue):
                self.loader.shm_batches += 1
            return batch

    def __iter__(self):
        return self

    def _shutdown(self):
        for q in self.index_queues:
            try:
                q.put(None)
            except Exception:  # noqa: BLE001
                pass
        # close the ring FIRST so writers blocked on a full ring wake with
        # BrokenPipeError and exit cleanly instead of being SIGTERM'd
        if isinstance(self.data_queue, _ShmDataQueue):
            self.data_queue.close()
        for w in self.workers:
            w.join(timeout=1)
            if w.is_alive():
                w.terminate()
        self.workers = []

    def __del__(self):
        if getattr(self, "workers", None):
            self._shutdown()


class _PlacedIter:
    """The host iterator's batches, each placed once on the current
    place."""

    def __init__(self, it, return_list):
        self._it = it
        self._return_list = return_list

    def __iter__(self):
        return self

    def __next__(self):
        return _to_tensor_nest(next(self._it), self._return_list)


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False, drop_last=False,
                 collate_fn=None, num_workers=0, use_buffer_reader=True,
                 prefetch_factor=2, use_shared_memory=True, timeout=0,
                 worker_init_fn=None, persistent_workers=False,
                 shm_ring_capacity=64 << 20):
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.batch_size = batch_size
        self.prefetch_factor = max(1, int(prefetch_factor))
        self.use_shared_memory = use_shared_memory
        self.shm_ring_capacity = shm_ring_capacity
        self.worker_init_fn = worker_init_fn
        # batches that arrived over the shared-memory ring (all runs)
        self.shm_batches = 0
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size", batch_size)
        elif isinstance(dataset, IterableDataset):
            self.batch_sampler = None
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)

    def _host_iter(self):
        """The batches as host values (numpy arrays or CPU tensors), not
        placed: the ``DevicePrefetcher`` copies them on its own stream."""
        if self.num_workers > 0:
            return _MultiProcessIter(self)
        return _SingleProcessIter(self)

    def __iter__(self):
        return _PlacedIter(self._host_iter(), self.return_list)

    def __len__(self):
        if isinstance(self.dataset, IterableDataset):
            raise TypeError("IterableDataset has no length")
        return len(self.batch_sampler)

    def __call__(self):
        return iter(self)
