"""Crash/hang diagnostics — dump the flight record when the process dies
or a serving dispatch stalls.

The port's copy of ``paddle_tpu/observability/watchdog.py``.  Three
triggers, one bundle:

* **Uncaught exception** — ``install()`` chains a ``sys.excepthook`` that
  writes the bundle, then defers to the previous hook (traceback printing
  is untouched).
* **SIGTERM / SIGINT** — the fleet scheduler's kill and the operator's ^C
  both get a dump before the default disposition runs.  Handlers are only
  installed over the *default* ones; custom handlers are never stomped.
* **Step watchdog** — ``arm(name, timeout)`` sets a deadline and
  ``disarm()`` clears it; ``Engine(decode_timeout_s=)`` arms it around
  every batched prefill, tail prefill and decode step.  A dispatch that
  exceeds it gets the same bundle written from the watchdog thread (the
  scheduler thread may be blocked in the token copy, which releases the
  GIL) — the hang becomes an artifact instead of a silent stall.

The bundle (``paddle_tpu.crash_dump.v1``, the JAX package's schema)
carries the last flight-recorder events, every thread's live span stack,
all-thread python stacks, and the sections registered with
:func:`add_section` (perfscope's device memory ledger).  Dumps land in
``PADDLE_TPU_DUMP_DIR`` (default: ``<tmpdir>/paddle_tpu_dumps``).
"""
from __future__ import annotations

import json
import logging
import os
import signal
import sys
import tempfile
import threading
import time
import traceback

from . import flight, trace

logger = logging.getLogger("paddle_tpu_torch.observability")

SCHEMA = "paddle_tpu.crash_dump.v1"
# how many flight events ride in the bundle (the ring may hold more)
DUMP_TAIL = int(os.environ.get("PADDLE_TPU_DUMP_TAIL", "256"))

_install_lock = threading.Lock()
_prev_excepthook = None
_prev_signal: dict[int, object] = {}
_last_dump_path: str | None = None
# extra bundle sections: name -> zero-arg provider returning JSON-safe
# data (perfscope registers the memory ledger here so an OOM names owners)
_sections: dict[str, object] = {}


def add_section(name: str, provider):
    """Attach a named section to every future crash bundle.  ``provider``
    is a zero-arg callable returning JSON-safe data; a provider that
    raises is skipped (a crash handler must never raise)."""
    _sections[str(name)] = provider


def dump_dir() -> str:
    return os.environ.get("PADDLE_TPU_DUMP_DIR") or os.path.join(
        tempfile.gettempdir(), "paddle_tpu_dumps")


def last_dump_path() -> str | None:
    return _last_dump_path


def thread_stacks() -> list[dict]:
    """Python stacks of every live thread (sys._current_frames)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sys._current_frames().items():
        out.append({"tid": tid, "name": names.get(tid, "?"),
                    "stack": traceback.format_stack(frame)})
    return out


def collect(reason: str, exc_info=None) -> dict:
    """The diagnostic bundle as a JSON-ready dict."""
    bundle = {
        "schema": SCHEMA,
        "reason": reason,
        "time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "pid": os.getpid(),
        "argv": list(sys.argv),
        "flight_events": flight.tail(DUMP_TAIL),
        "open_spans": {str(tid): st
                       for tid, st in trace.open_spans().items()},
        "threads": thread_stacks(),
    }
    for name, provider in list(_sections.items()):
        try:
            bundle[name] = provider()
        except Exception:  # noqa: BLE001 — a broken section never blocks a dump
            pass
    if exc_info is not None and exc_info[0] is not None:
        etype, evalue, etb = exc_info
        bundle["exception"] = {
            "type": etype.__name__,
            "message": str(evalue),
            "traceback": traceback.format_exception(etype, evalue, etb),
        }
    return bundle


def dump(reason: str, exc_info=None, path: str | None = None) -> str | None:
    """Write the bundle; returns the path (None when the write itself
    fails — a crash handler must never raise)."""
    global _last_dump_path
    try:
        bundle = collect(reason, exc_info)
        if path is None:
            d = dump_dir()
            os.makedirs(d, exist_ok=True)
            safe = "".join(c if c.isalnum() or c in "._-" else "_"
                           for c in reason)[:64]
            path = os.path.join(
                d, f"crash_{os.getpid()}_{int(time.time() * 1e3)}_{safe}.json")
        with open(path, "w") as f:
            json.dump(bundle, f, default=repr)
        _last_dump_path = path
        logger.warning("paddle_tpu_torch flight recorder: %s", json.dumps(
            {"event": "diagnostic_dump", "reason": reason, "path": path,
             "flight_events": len(bundle["flight_events"]),
             "threads": len(bundle["threads"])}))
        return path
    except Exception:  # pragma: no cover - last-resort guard
        try:
            traceback.print_exc(file=sys.stderr)
        except Exception:
            pass
        return None


# -- excepthook + signal installation ----------------------------------------

def _excepthook(etype, evalue, etb):
    dump("uncaught_exception", (etype, evalue, etb))
    if _prev_excepthook is not None:
        _prev_excepthook(etype, evalue, etb)
    else:  # pragma: no cover
        sys.__excepthook__(etype, evalue, etb)


def _make_signal_handler(signum):
    def handler(sig, frame):
        dump(f"signal_{signal.Signals(sig).name}")
        prev = _prev_signal.get(sig)
        if callable(prev):
            prev(sig, frame)
        elif prev == signal.SIG_DFL:
            # restore the default disposition and re-deliver so the exit
            # status still says "killed by signal"
            signal.signal(sig, signal.SIG_DFL)
            os.kill(os.getpid(), sig)
    return handler


def installed() -> bool:
    return sys.excepthook is _excepthook


def install():
    """Idempotent: chain the excepthook; take SIGTERM/SIGINT only where
    the current handler is the default (custom handlers win).  Signal
    setup silently no-ops off the main thread."""
    global _prev_excepthook
    with _install_lock:
        if sys.excepthook is not _excepthook:
            _prev_excepthook = sys.excepthook
            sys.excepthook = _excepthook
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                cur = signal.getsignal(sig)
                if cur == signal.SIG_DFL or cur is signal.default_int_handler:
                    _prev_signal[sig] = cur
                    signal.signal(sig, _make_signal_handler(sig))
            except (ValueError, OSError):  # not main thread / exotic platform
                pass


def uninstall():
    global _prev_excepthook
    with _install_lock:
        if sys.excepthook is _excepthook:
            sys.excepthook = _prev_excepthook or sys.__excepthook__
        _prev_excepthook = None
        for sig, prev in list(_prev_signal.items()):
            try:
                if prev is not None:
                    signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
            _prev_signal.pop(sig, None)


def _bootstrap_from_env():
    if os.environ.get("PADDLE_TPU_CRASH_DUMP", "1").lower() not in (
            "0", "false", "no", "off"):
        install()


# -- step watchdog -----------------------------------------------------------

def step_timeout() -> float | None:
    """PADDLE_TPU_STEP_TIMEOUT_S, read per arm so tests/operators can flip
    it at runtime; None/<=0 disables."""
    raw = os.environ.get("PADDLE_TPU_STEP_TIMEOUT_S", "")
    try:
        t = float(raw)
    except ValueError:
        return None
    return t if t > 0 else None


class _StepWatchdog:
    """One daemon thread, lazily started on first arm.  arm() sets a
    deadline; disarm() clears it.  A deadline that expires while still
    armed fires ONE dump (reason step_timeout:<name>) and waits for the
    next arm — it diagnoses the hang, it does not kill the process."""

    def __init__(self):
        self._cv = threading.Condition()
        self._thread: threading.Thread | None = None
        self._deadline: float | None = None
        self._name = ""
        self._timeout = 0.0
        self.fired_count = 0

    def arm(self, name: str, timeout: float):
        with self._cv:
            self._name = name
            self._timeout = timeout
            self._deadline = time.perf_counter() + timeout
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, daemon=True,
                    name="paddle-tpu-step-watchdog")
                self._thread.start()
            self._cv.notify()

    def disarm(self):
        with self._cv:
            self._deadline = None
            self._cv.notify()

    def _run(self):
        while True:
            with self._cv:
                if self._deadline is None:
                    self._cv.wait()
                    continue
                now = time.perf_counter()
                if now < self._deadline:
                    self._cv.wait(self._deadline - now)
                    continue
                name, timeout = self._name, self._timeout
                self._deadline = None  # fire once per arm
                self.fired_count += 1
            flight.record("watchdog", "step_timeout", fn=name,
                          timeout_s=timeout)
            dump(f"step_timeout:{name}")


_watchdog = _StepWatchdog()


def arm(name: str, timeout: float | None = None) -> bool:
    """Arm the step watchdog; returns True when armed (a timeout was given
    or PADDLE_TPU_STEP_TIMEOUT_S is set).  Callers pair this with
    disarm() in a finally block."""
    t = timeout if timeout is not None else step_timeout()
    if t is None:
        return False
    _watchdog.arm(name, t)
    return True


def disarm():
    _watchdog.disarm()
