"""Reader decorators — parity with python/paddle/reader/decorator.py
(cache:52, map_readers:92, shuffle:134, chain:183, compose:248,
buffered:308, firstn:367, xmap_readers:380, multiprocess_reader:505).

The port's copy of ``paddle_tpu/reader/decorator.py``: semantics
preserved; the plumbing uses the same queue-of-samples scheme the
reference uses (a Queue feeding consumer iterators, end-signals to
terminate).  ``buffered``, ``xmap_readers`` and ``multiprocess_reader``
run their readers and mappers on threads of the training process, as
the JAX module does: readers build numpy samples and leave the card to
the consumer (``paddle.io``'s rule for DataLoader workers)."""
from __future__ import annotations

import itertools
import queue
import random
import threading

__all__ = ["cache", "map_readers", "buffered", "compose", "chain",
           "shuffle", "firstn", "xmap_readers", "multiprocess_reader"]


def cache(reader):
    """Cache the first full pass in memory; later passes replay it."""
    all_data = tuple(reader())

    def __impl__():
        return iter(all_data)

    return __impl__


def map_readers(func, *readers):
    """Yield func(*one_sample_from_each_reader)."""
    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)

    return reader


def shuffle(reader, buf_size):
    """Buffered shuffle: fill `buf_size` samples, shuffle, emit (the
    reference's windowed shuffle, not a global one)."""
    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            random.shuffle(buf)
            for b in buf:
                yield b

    return data_reader


def chain(*readers):
    """Concatenate readers: all of r1, then all of r2, ..."""
    def reader():
        return itertools.chain(*[r() for r in readers])

    return reader


def compose(*readers, **kwargs):
    """Zip readers into flat tuples: (a1, b1a, b1b) from a and (b..,b..).
    check_alignment (default True) raises ComposeNotAligned when one
    reader ends early."""
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        if isinstance(x, tuple):
            return x
        return (x,)

    def reader():
        rs = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum(list(map(make_tuple, outputs)), ())
        else:
            for outputs in itertools.zip_longest(*rs):
                if any(o is None for o in outputs):
                    raise ComposeNotAligned(
                        "outputs of readers are not aligned")
                yield sum(list(map(make_tuple, outputs)), ())

    return reader


class ComposeNotAligned(ValueError):
    pass


def buffered(reader, size):
    """Read ahead up to `size` samples on a worker thread."""
    class _End:
        pass

    def read_worker(r, q):
        for d in r:
            q.put(d)
        q.put(_End)

    def data_reader():
        r = reader()
        q = queue.Queue(maxsize=size)
        t = threading.Thread(target=read_worker, args=(r, q), daemon=True)
        t.start()
        e = q.get()
        while e is not _End:
            yield e
            e = q.get()

    return data_reader


def firstn(reader, n):
    """Limit a reader to its first n samples."""
    def firstn_reader():
        for i, item in enumerate(reader()):
            if i == n:
                break
            yield item

    return firstn_reader


class XmapEndSignal:
    pass


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Map samples with a pool of threads; `order=True` preserves the
    input order (reference decorator.py:380 thread scheme: one feeder,
    process_num mappers, end-signal handshake)."""
    end = XmapEndSignal()

    def read_worker(r, in_q):
        for i in r():
            in_q.put(i)
        in_q.put(end)

    def order_read_worker(r, in_q):
        for order_id, sample in enumerate(r()):
            in_q.put((order_id, sample))
        in_q.put(end)

    def handle_worker(in_q, out_q, mapper):
        sample = in_q.get()
        while not isinstance(sample, XmapEndSignal):
            out_q.put(mapper(sample))
            sample = in_q.get()
        in_q.put(end)
        out_q.put(end)

    def order_handle_worker(in_q, out_q, mapper):
        ins = in_q.get()
        while not isinstance(ins, XmapEndSignal):
            order_id, sample = ins
            out_q.put((order_id, mapper(sample)))
            ins = in_q.get()
        in_q.put(end)
        out_q.put(end)

    def xreader():
        in_q = queue.Queue(buffer_size)
        out_q = queue.Queue(buffer_size)
        target = order_read_worker if order else read_worker
        t = threading.Thread(target=target, args=(reader, in_q), daemon=True)
        t.start()
        target = order_handle_worker if order else handle_worker
        for _ in range(process_num):
            threading.Thread(target=target, args=(in_q, out_q, mapper),
                             daemon=True).start()
        finish = 0
        if order:
            # reorder with a pending-heap: mappers emit (order_id, result)
            pending, next_id = {}, 0
            while finish < process_num:
                sample = out_q.get()
                if isinstance(sample, XmapEndSignal):
                    finish += 1
                    continue
                oid, result = sample
                pending[oid] = result
                while next_id in pending:
                    yield pending.pop(next_id)
                    next_id += 1
            for oid in sorted(pending):
                yield pending[oid]
        else:
            while finish < process_num:
                sample = out_q.get()
                if isinstance(sample, XmapEndSignal):
                    finish += 1
                else:
                    yield sample

    return xreader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Interleave multiple readers on worker THREADS (reference uses
    processes + pipes; forking after the card's runtime is initialised is
    unsafe, so threads implement the same contract: samples from all
    readers, order unspecified)."""
    def thread_reader():
        q = queue.Queue(queue_size)
        done = object()

        def worker(r):
            for s in r():
                q.put(s)
            q.put(done)

        for r in readers:
            threading.Thread(target=worker, args=(r,), daemon=True).start()
        finished = 0
        while finished < len(readers):
            s = q.get()
            if s is done:
                finished += 1
            else:
                yield s

    return thread_reader
