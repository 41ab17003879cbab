"""Fault injection at named seams of the serving path.

The port's own copy of ``paddle_tpu/testing/faults.py`` (pure Python: the
port imports nothing of the JAX package), with the serving seams and the
modes the serving tests use.  Production code marks a seam with
``fault_point("serving.decode")``; nothing happens unless a fault is armed
for that name, so the call is a dict check on the hot path.  Tests arm a
fault programmatically::

    with faults.inject("serving.prefill", times=1):
        ...                                   # the next prefill raises

Modes: ``raise`` (:class:`FaultInjected`, or the ``exc=`` given) and
``delay`` (sleep ``seconds``: a stalled dispatch).  ``after=K`` lets the
first K hits through; ``times=N`` fires N times (``None``: forever).
:func:`hits` counts every crossing of a seam while any fault is armed.

Seams in the port: ``serving.scheduler`` (each scheduler iteration),
``serving.prefill`` (before each batched prefill or tail prefill: a crash
there loses zero-token requests), ``serving.decode`` (before each decode
step: its requests have streamed their first token), ``serving.stream``
(each emitted token), ``serving.rebuild`` (the supervisor's rebuild),
``gateway.dispatch`` (each pass of the gateway's dispatcher loop, whose
death must degrade ``/healthz``), ``scale.up_build`` (before the
autoscaler's cold build), ``scale.down_drain`` (before a scale-down's
drain), ``autoscaler.tick`` (each control-loop tick), ``rollout.build``
(before each rollout build), ``rollout.canary_gate`` (each canary
judgment) and ``rollout.drain_old`` (each retiring drain).  Every triggered fault lands in the
flight recorder (``kind="fault"``), so a crash dump shows what was
injected where.
"""
from __future__ import annotations

import contextlib
import threading
import time

__all__ = ["FaultInjected", "fault_point", "inject", "arm", "disarm",
           "reset", "hits"]


class FaultInjected(RuntimeError):
    """Raised by an armed ``raise`` fault point."""

    def __init__(self, name: str, mode: str = "raise"):
        super().__init__(f"injected fault at {name!r} (mode={mode})")
        self.point = name
        self.mode = mode


class _Fault:
    __slots__ = ("name", "mode", "times", "after", "seconds", "exc",
                 "triggered")

    def __init__(self, name, mode="raise", times=1, after=0, seconds=0.05,
                 exc=None):
        if mode not in ("raise", "delay"):
            raise ValueError(f"unknown fault mode {mode!r}")
        self.name = name
        self.mode = mode
        self.times = None if times is None else int(times)
        self.after = int(after)
        self.seconds = float(seconds)
        self.exc = exc
        self.triggered = 0


_lock = threading.Lock()
_faults: dict[str, _Fault] = {}
_hits: dict[str, int] = {}


def arm(name: str, mode: str = "raise", **kw) -> _Fault:
    """Arm one fault; replaces any previous fault on the same name."""
    f = _Fault(name, mode, **kw)
    with _lock:
        _faults[name] = f
    return f


def disarm(name: str):
    with _lock:
        _faults.pop(name, None)


def reset():
    """Disarm everything and zero the hit counters (test teardown)."""
    with _lock:
        _faults.clear()
        _hits.clear()


def hits(name: str) -> int:
    """How many times ``name`` was crossed while any fault was armed."""
    with _lock:
        return _hits.get(name, 0)


@contextlib.contextmanager
def inject(name: str, mode: str = "raise", **kw):
    """Arm a fault for the scope."""
    f = arm(name, mode, **kw)
    try:
        yield f
    finally:
        disarm(name)


def fault_point(name: str, **ctx):
    """Seam marker: raises or sleeps when a fault is armed for ``name``.
    ``ctx`` names what the seam was doing (its scalars ride the flight
    event)."""
    if not _faults:
        return
    with _lock:
        _hits[name] = _hits.get(name, 0) + 1
        f = _faults.get(name)
        if f is None:
            return
        f.triggered += 1
        if f.triggered <= f.after:
            return
        if f.times is not None and f.triggered - f.after > f.times:
            return
    from ..observability import flight
    flight.record("fault", name, mode=f.mode, hit=f.triggered,
                  **{k: v for k, v in ctx.items()
                     if isinstance(v, (str, int, float, bool))})
    if f.mode == "delay":
        time.sleep(f.seconds)
        return
    if f.exc is not None:
        raise f.exc
    raise FaultInjected(name, f.mode)
