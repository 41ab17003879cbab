"""Tracing spans — nested host-side timeline events.

The port's copy of ``paddle_tpu/observability/trace.py``.
``span("serving.decode", active=n)`` is a context manager *and* decorator
marking one timed region.  Spans nest through a thread-local stack (each
span records its parent's id), carry ``perf_counter`` timestamps, and
land in three places:

* the **span ring** — a bounded deque of completed spans
  (:func:`chrome_events` renders them as chrome-trace ``"cat": "span"``
  events on the same clock as the journey and device lanes);
* the **flight recorder** (flight.py) — span open/close are flight events,
  so the crash/hang dump shows which regions were in flight;
* the **open-span table** — per-thread stacks of live spans the watchdog
  snapshots when a step stalls ("the decode is 40 s into its copy").

Spans are always on (the cost is two perf_counter reads, two flight
appends and one ring append per span) and are used only at non-per-op
sites: a batched prefill, a decode step, an adapter load.
"""
from __future__ import annotations

import functools
import itertools
import os
import threading
import time
from collections import deque

from . import flight

_lock = threading.Lock()


def _fresh_lock_in_child():
    # a forked child (a DataLoader worker) may inherit the lock held by a
    # thread that does not exist there: give it a free one
    global _lock
    _lock = threading.Lock()


os.register_at_fork(after_in_child=_fresh_lock_in_child)

_ids = itertools.count(1)
_SPANS: deque = deque(
    maxlen=max(16, int(os.environ.get("PADDLE_TPU_SPAN_RING", "4096"))))
_local = threading.local()
# tid -> list of live span handles (the watchdog reads this from another
# thread, so it cannot live in _local)
_open_by_tid: dict[int, list] = {}


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class span:
    """One timed region: ``with span("checkpoint.save", dir=d) as sp: ...``
    or ``@span("collective.all_reduce")``.  Attrs may be added to
    ``sp.attrs`` while the span is open; they ship with the completed
    record.  As a decorator each call opens a fresh span."""

    __slots__ = ("name", "attrs", "id", "parent_id", "tid", "_t0", "_wall")

    def __init__(self, name: str, attrs: dict | None = None, **kw):
        self.name = name
        self.attrs = dict(attrs) if attrs else {}
        self.attrs.update(kw)
        self.id = None
        self.parent_id = None
        self.tid = None
        self._t0 = None
        self._wall = None

    def __enter__(self):
        st = _stack()
        self.id = next(_ids)
        self.parent_id = st[-1].id if st else None
        self.tid = threading.get_ident()
        st.append(self)
        with _lock:
            _open_by_tid[self.tid] = st
        self._wall = time.time()
        self._t0 = time.perf_counter()
        flight.record("span_begin", self.name, span_id=self.id,
                      parent_id=self.parent_id, **self.attrs)
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        elif self in st:  # mis-nested close (generator teardown): best effort
            st.remove(self)
        rec = {"name": self.name, "id": self.id, "parent_id": self.parent_id,
               "tid": self.tid, "ts": self._t0 * 1e6, "dur": dur * 1e6,
               "wall_ts": self._wall, "attrs": dict(self.attrs)}
        if exc_type is not None:
            rec["attrs"]["status"] = "error"
            rec["attrs"]["exception"] = exc_type.__name__
        with _lock:
            _SPANS.append(rec)
        flight.record("span_end", self.name, span_id=self.id,
                      dur_ms=round(dur * 1e3, 3), **rec["attrs"])
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(self.name, self.attrs):
                return fn(*args, **kwargs)
        return wrapper

    @property
    def elapsed(self) -> float:
        return 0.0 if self._t0 is None else time.perf_counter() - self._t0


def current_span() -> span | None:
    st = _stack()
    return st[-1] if st else None


def spans(name: str | None = None) -> list[dict]:
    """Completed spans, oldest first (optionally filtered by name)."""
    with _lock:
        out = list(_SPANS)
    if name is None:
        return out
    return [s for s in out if s["name"] == name]


def open_spans() -> dict[int, list[dict]]:
    """{tid: [live span snapshots, outermost first]} across ALL threads —
    the watchdog's view of what a stalled process is doing right now."""
    with _lock:
        table = {tid: list(st) for tid, st in _open_by_tid.items()}
    out = {}
    for tid, st in table.items():
        if st:
            out[tid] = [{"name": s.name, "id": s.id,
                         "parent_id": s.parent_id,
                         "elapsed_s": round(s.elapsed, 6),
                         "attrs": dict(s.attrs)} for s in st]
    return out


def clear():
    """Drop completed spans (live stacks are untouched)."""
    with _lock:
        _SPANS.clear()


def chrome_events() -> list[dict]:
    """Completed spans as chrome-trace 'X' events (profiler merge).  The
    ts base is perf_counter*1e6 — the same clock RecordEvent spans and
    counter samples use, so everything aligns on one timeline."""
    pid = os.getpid()
    out = []
    for s in spans():
        args = dict(s["attrs"])
        args["span_id"] = s["id"]
        if s["parent_id"] is not None:
            args["parent_id"] = s["parent_id"]
        out.append({"name": s["name"], "ph": "X", "ts": s["ts"],
                    "dur": s["dur"], "pid": pid, "tid": s["tid"],
                    "cat": "span", "args": args})
    return out
