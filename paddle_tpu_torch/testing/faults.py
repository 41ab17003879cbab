"""Fault injection at named seams of the serving and training paths.

The port's own copy of ``paddle_tpu/testing/faults.py`` (pure Python: the
port imports nothing of the JAX package), with the same seams and modes.
Production code marks a seam with ``fault_point("serving.decode")``;
nothing happens unless a fault is armed for that name, so the call is a
dict check on the hot path.  Tests arm a fault programmatically::

    with faults.inject("serving.prefill", times=1):
        ...                                   # the next prefill raises

Modes: ``raise`` (:class:`FaultInjected`, or the ``exc=`` given),
``torn`` (truncate the file passed as ``path=`` to half its size, then
raise: a torn write), ``delay`` (sleep ``seconds``: a stalled dispatch)
and ``kill`` (``os._exit(exit_code)``: a hard preemption, for subprocess
tests).  ``after=K`` lets the first K hits through; ``times=N`` fires N
times (``None``: forever); ``match={key: value}`` lets only the crossings
whose context carries those values count (a seam crossed by two objects
at once, as two gateways' dispatchers cross ``gateway.dispatch``).
:func:`hits` counts every crossing of a seam while any fault is armed.
``PADDLE_TPU_FAULTS="train.step:kill:after=5,fs.upload:raise"`` arms
faults from the environment at import (subprocess harnesses).

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
judgment) and ``rollout.drain_old`` (each retiring drain); on the training
path ``checkpoint.write``, ``checkpoint.manifest``, ``checkpoint.commit``,
``checkpoint.promote``, ``checkpoint.upload``,
``checkpoint.upload_commit``, ``fs.upload``, ``fs.download``,
``restore.read``, ``restore.rng`` and ``train.step``.  Every triggered
fault lands in the flight recorder (``kind="fault"``), so a crash dump
shows what was injected where.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time

__all__ = ["FaultInjected", "fault_point", "inject", "arm", "armed",
           "disarm", "reset", "hits"]


class FaultInjected(RuntimeError):
    """Raised by an armed ``raise`` fault point."""

    def __init__(self, name: str, mode: str = "raise"):
        super().__init__(f"injected fault at {name!r} (mode={mode})")
        self.point = name
        self.mode = mode


class _Fault:
    __slots__ = ("name", "mode", "times", "after", "seconds", "exit_code",
                 "exc", "match", "triggered")

    def __init__(self, name, mode="raise", times=1, after=0, seconds=0.05,
                 exit_code=43, exc=None, match=None):
        if mode not in ("raise", "torn", "delay", "kill"):
            raise ValueError(f"unknown fault mode {mode!r}")
        self.name = name
        self.mode = mode
        self.times = None if times is None else int(times)
        self.after = int(after)
        self.seconds = float(seconds)
        self.exit_code = int(exit_code)
        self.exc = exc
        self.match = dict(match) if match else None
        self.triggered = 0


_lock = threading.Lock()
_faults: dict[str, _Fault] = {}
_hits: dict[str, int] = {}


def armed() -> bool:
    return bool(_faults)


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


def _torn(path):
    if path and os.path.isfile(path):
        size = os.path.getsize(path)
        with open(path, "r+b") as fh:
            fh.truncate(max(1, size // 2))


def fault_point(name: str, path: str | None = None, **ctx):
    """Seam marker: raises, tears ``path``, sleeps or exits when a fault
    is armed for ``name``.  ``ctx`` names what the seam was doing (its
    scalars ride the flight event)."""
    if not _faults:
        return
    with _lock:
        _hits[name] = _hits.get(name, 0) + 1
        f = _faults.get(name)
        if f is None:
            return
        if f.match is not None and any(
                ctx.get(k) is not v and ctx.get(k) != v
                for k, v in f.match.items()):
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
    if f.mode == "kill":
        os._exit(f.exit_code)
    if f.mode == "torn":
        _torn(path)
    if f.exc is not None:
        raise f.exc
    raise FaultInjected(name, f.mode)


def _load_env(spec: str | None = None):
    """Arm faults from ``PADDLE_TPU_FAULTS``: comma-separated entries of
    ``name[:mode[:key=val]...]``, e.g. ``train.step:kill:after=5``."""
    spec = spec if spec is not None else os.environ.get(
        "PADDLE_TPU_FAULTS", "")
    for entry in filter(None, (e.strip() for e in spec.split(","))):
        parts = entry.split(":")
        name, mode = parts[0], (parts[1] if len(parts) > 1 else "raise")
        kw: dict = {}
        for field in parts[2:]:
            k, _, v = field.partition("=")
            kw[k] = None if v == "none" else (
                float(v) if k == "seconds" else int(v))
        arm(name, mode, **kw)


_load_env()
