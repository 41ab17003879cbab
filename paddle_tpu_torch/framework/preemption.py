"""Preemption handling — turn SIGTERM into a checkpoint, not a lost run
(the port's copy of ``paddle_tpu/framework/preemption.py``).

Fleets of accelerators preempt routinely (Varuna's whole premise is
training on spot capacity); the scheduler's kill arrives as SIGTERM with
a grace window.  This module converts the first such signal into a
*request*: a flag the train loop (the hapi fit loop via
``CheckpointCallback``) polls at step boundaries to write an emergency
checkpoint and stop cleanly.  A second delivery of the same
signal escalates — handlers are uninstalled and the signal is re-raised,
so the watchdog chain (flight-tail crash dump, then the default
disposition) still runs for an impatient scheduler.

Layering with the watchdog: :func:`install` *wraps* whatever handler is
current (including the watchdog's dump-then-die handler) instead of
replacing it blindly; :func:`uninstall` restores it.  The first signal is
swallowed on purpose — dying immediately is exactly what this module
exists to avoid — the previous chain runs on escalation or after
uninstall.

Programmatic use (tests, cooperative schedulers)::

    preemption.request()          # same effect as one SIGTERM
    if preemption.requested(): ...
"""
from __future__ import annotations

import contextlib
import os
import signal
import threading

from ..observability import flight

__all__ = ["TrainingPreempted", "install", "uninstall", "guard",
           "request", "requested", "clear", "mark_saved", "last_saved_step"]


class TrainingPreempted(RuntimeError):
    """Raised by a train step after the emergency checkpoint is on disk:
    the run was preempted and should exit so the scheduler can reschedule;
    ``step`` is the checkpointed optimizer step to resume from."""

    def __init__(self, step: int | None = None, msg: str | None = None):
        super().__init__(
            msg or f"training preempted; emergency checkpoint at step {step}")
        self.step = step


_requested = threading.Event()
_lock = threading.Lock()
_prev: dict[int, object] = {}
_last_saved_step: int | None = None


def requested() -> bool:
    return _requested.is_set()


def request(reason: str = "api"):
    """Arm the preemption flag (what the signal handler does)."""
    if not _requested.is_set():
        _requested.set()
        flight.record("preemption", "requested", reason=reason)


def clear():
    global _last_saved_step
    _requested.clear()
    _last_saved_step = None


def mark_saved(step: int, topology: dict | None = None):
    """Train loops call this right after the emergency checkpoint commits
    (flight event + bookkeeping for tests/operators).  `topology` is the
    writer's mesh axes (``{"dp": 2, "mp": 4}``) — recorded so a resume on
    a DIFFERENT mesh (elastic restart) can be traced back to the topology
    that wrote the emergency checkpoint."""
    global _last_saved_step
    _last_saved_step = int(step)
    attrs = {"step": int(step)}
    if topology:
        attrs["topology"] = str(topology)
    flight.record("preemption", "emergency_checkpoint", **attrs)


def last_saved_step() -> int | None:
    return _last_saved_step


def _handler(sig, frame):
    if _requested.is_set():
        # second delivery: the grace period is over — restore the previous
        # chain (watchdog dump → default disposition) and re-deliver
        uninstall()
        os.kill(os.getpid(), sig)
        return
    request(reason=f"signal_{signal.Signals(sig).name}")


def installed() -> bool:
    return bool(_prev)


def install(signals=(signal.SIGTERM, signal.SIGINT)) -> bool:
    """Wrap the current handlers (idempotent).  Returns False when signal
    installation is impossible (non-main thread) — training still works,
    preemption can only arrive via :func:`request`."""
    with _lock:
        ok = True
        for sig in signals:
            if sig in _prev:
                continue
            try:
                cur = signal.getsignal(sig)
                signal.signal(sig, _handler)
                _prev[sig] = cur
            except (ValueError, OSError):  # not main thread
                ok = False
        return ok


def uninstall():
    with _lock:
        for sig, prev in list(_prev.items()):
            try:
                if signal.getsignal(sig) is _handler:
                    signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
            _prev.pop(sig, None)


@contextlib.contextmanager
def guard(signals=(signal.SIGTERM, signal.SIGINT)):
    """Install for the scope of a train loop, restore after."""
    install(signals)
    try:
        yield
    finally:
        uninstall()
