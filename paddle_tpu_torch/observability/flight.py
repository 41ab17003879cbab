"""Always-on flight recorder — a bounded ring of structured runtime events.

The port's copy of ``paddle_tpu/observability/flight.py``.  Metrics
(metrics.py) answer "how much / how often"; the flight recorder answers
"what happened, in what order" when the process dies or hangs — the
timeline layer a serving fleet keeps permanently armed because the
interesting crash never reproduces under a profiler.

Design constraints:

* **Always on.**  Unlike the metrics registry's samples (gated by the
  telemetry switch), the recorder runs from import: a fixed-size deque of
  plain dicts, one lock-guarded append per event.  That is affordable
  because events come only from *non-per-op* sites — span open/close
  (trace.py), admissions, evictions, sheds, restarts, armed faults.
* **Bounded.**  ``PADDLE_TPU_FLIGHT_EVENTS`` (default 1024) caps the ring;
  old events fall off the front.  A crash dump therefore always costs the
  same and always shows the *most recent* history.
* **JSON-safe.**  Event attrs are scalars (str/int/float/bool) so the
  watchdog can serialize a dump bundle without touching the objects that
  may be mid-crash.

Disable entirely (paranoid benchmarking) with ``PADDLE_TPU_FLIGHT=0``.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque

DEFAULT_CAPACITY = 1024

_lock = threading.Lock()


def _fresh_lock_in_child():
    # a forked child (a DataLoader worker) may inherit the lock held by a
    # thread that does not exist there: give it a free one
    global _lock
    _lock = threading.Lock()


os.register_at_fork(after_in_child=_fresh_lock_in_child)

_seq = itertools.count(1)
_EVENTS: deque = deque(
    maxlen=max(8, int(os.environ.get("PADDLE_TPU_FLIGHT_EVENTS",
                                     DEFAULT_CAPACITY))))
_ENABLED = os.environ.get("PADDLE_TPU_FLIGHT", "1").lower() not in (
    "0", "false", "no", "off")
# process-local monotonic epoch: event "mono" values are comparable with
# each other and with span timestamps (trace.py uses the same clock)
_T0 = time.perf_counter()


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool):
    global _ENABLED
    _ENABLED = bool(on)


def capacity() -> int:
    return _EVENTS.maxlen or 0


def set_capacity(n: int):
    """Resize the ring, keeping the newest events (tests; runtime sizing
    should use the PADDLE_TPU_FLIGHT_EVENTS env var)."""
    global _EVENTS
    with _lock:
        _EVENTS = deque(_EVENTS, maxlen=max(8, int(n)))


def record(kind: str, name: str, /, **attrs):
    """Append one structured event.  `attrs` values must be JSON-safe
    scalars — the recorder stores them as-is and the crash dump serializes
    them verbatim.  kind/name are positional-only so attrs may use those
    words too."""
    if not _ENABLED:
        return
    ev = {"seq": next(_seq), "ts": time.time(),
          "mono": time.perf_counter() - _T0,
          "tid": threading.get_ident(), "kind": kind, "name": name,
          "attrs": attrs}
    with _lock:
        _EVENTS.append(ev)


def events(kind: str | None = None) -> list[dict]:
    """Snapshot of the ring, oldest first (optionally one kind)."""
    with _lock:
        evs = list(_EVENTS)
    if kind is None:
        return evs
    return [e for e in evs if e["kind"] == kind]


def tail(n: int = 64) -> list[dict]:
    """The newest `n` events, oldest first — the crash-dump payload."""
    with _lock:
        evs = list(_EVENTS)
    return evs[-n:]


def clear():
    with _lock:
        _EVENTS.clear()
