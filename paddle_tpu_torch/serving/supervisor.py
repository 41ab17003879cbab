"""EngineSupervisor — detect a dead engine, rebuild it, re-dispatch the
work that is still duplication-safe.

The port's counterpart of ``paddle_tpu/serving/supervisor.py``.  An
:class:`~paddle_tpu_torch.serving.engine.Engine` whose scheduler crashes
(or whose decode stalls) is fail-stop by design: restarting its loop
over a failed pool would serve garbage.  The supervisor restarts around
it:

* **detect**: a monitor thread polls ``Engine.health()``; ``dead`` is a
  crash, and a frozen ``progress_age_s`` with work pending past
  ``stall_timeout_s`` (once the build is warm) is a stall, after which
  the engine is :meth:`~paddle_tpu_torch.serving.engine.Engine.abandon`-ed
  (its requests are classified as for a crash).
* **rebuild**: the old engine is shut down (its decode graph, pools and
  banks freed once its thread has exited) and a fresh engine is built by
  the caller's ``factory``; each build captures its own decode graph, on
  its own stream.  The supervisor holds no engine's lock while it builds,
  and the capture runs on the new engine's thread, outside any lock the
  monitor takes.
* **re-dispatch**: the dying engine offers its zero-token requests through
  its ``redispatch_hook``; the supervisor parks them and re-enqueues the
  same handles in the rebuilt engine, so callers blocked on ``result()``
  never notice.  Requests that streamed tokens fail with
  ``RequestInterruptedError`` and are never replayed.  A re-dispatched
  request keeps its journey: the death -> rebuilt-engine window is a
  ``rebuild`` phase on the same journey id.
* **telemetry**: the JAX supervisor's flight events (``park``,
  ``stall``, ``teardown``, ``rebuild_failed``, ``giveup``, ``restart``)
  and ``paddle_tpu_serving_engine_restarts_total{engine}``.

Restarts are budgeted (``max_restarts`` in ``restart_window_s``); past the
budget the supervisor gives up, fails the parked requests with
``EngineDeadError`` and reports not-alive.  The supervisor is Engine-shaped
(``submit``, ``load``, ``health``, ``drain``, ``shutdown`` and the rest
proxy to the current engine)::

    sup = EngineSupervisor(lambda: Engine(model, max_slots=8),
                           stall_timeout_s=30.0)
    sup.submit(prompt, max_new_tokens=32).result()
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from ..observability import flight, registry
from ..testing import faults
from .engine import (Engine, EngineClosedError, EngineDeadError,
                     EngineStalledError, QueueFullError)

__all__ = ["EngineSupervisor", "SERVING_RESTARTS"]

SERVING_RESTARTS = "paddle_tpu_serving_engine_restarts_total"


class EngineSupervisor:
    """Self-healing wrapper around one Engine (see the module doc).

    Args:
        factory: zero-argument callable returning a fresh :class:`Engine`
            (called once here and once a restart).
        name: the supervisor's name, in its thread's and errors' names.
        max_restarts: restarts allowed in ``restart_window_s``; one more
            death past it makes the supervisor give up.
        restart_window_s: the budget's sliding window.
        poll_interval_s: the monitor thread's period.
        stall_timeout_s: abandon the engine when its scheduler makes no
            progress this long with work pending, once it is warm (its
            decode step captured); None detects crashes only.  Read at
            every poll.
        max_redispatch: re-dispatches allowed a request; past it the
            request fails with ``EngineDeadError``.
    """

    def __init__(self, factory: Callable[[], Engine], *,
                 name: str = "engine", max_restarts: int = 3,
                 restart_window_s: float = 60.0,
                 poll_interval_s: float = 0.05,
                 stall_timeout_s: Optional[float] = None,
                 max_redispatch: int = 2):
        self.factory = factory
        self.name = str(name)
        self.max_restarts = int(max_restarts)
        self.restart_window_s = float(restart_window_s)
        self.poll_interval_s = float(poll_interval_s)
        self.stall_timeout_s = (None if stall_timeout_s is None
                                else float(stall_timeout_s))
        self.max_redispatch = int(max_redispatch)
        self._lock = threading.Lock()
        self._stop_ev = threading.Event()
        self._wake_ev = threading.Event()
        self._parked: List = []
        self._restart_times: List[float] = []
        self._failed: Optional[BaseException] = None
        self._restarting = False
        self._restarts = 0
        self._redispatched = 0
        self._build_stats: List[dict] = []
        self._engine = self._attach(factory())
        self._thread = threading.Thread(
            target=self._watch, name=f"paddle-tpu-torch-supervisor-{name}",
            daemon=True)
        self._thread.start()

    def _attach(self, eng: Engine) -> Engine:
        eng.redispatch_hook = self._take_requests
        return eng

    # -- redispatch hook (runs on the dying engine's thread) -----------------
    def _take_requests(self, requests, cause):
        """Take the zero-token requests still inside their re-dispatch
        budget; they wait here for the rebuilt engine."""
        now = time.perf_counter()
        with self._lock:
            if self._stop_ev.is_set() or self._failed is not None:
                return []
            taken = [r for r in requests
                     if r.redispatches < self.max_redispatch]
            for r in taken:
                r._park_t0 = now          # the journey's rebuild phase
            self._parked.extend(taken)
        if taken:
            flight.record("supervisor", "park", engine=self.name,
                          n=len(taken), error=type(cause).__name__,
                          requests=",".join(str(r.request_id)
                                            for r in taken))
        self._wake_ev.set()
        return taken

    # -- monitor thread ------------------------------------------------------
    def _watch(self):
        while not self._stop_ev.is_set():
            with self._lock:
                eng = self._engine
            h = eng.health()
            if h["dead"]:
                self._restart(eng)
            elif (self.stall_timeout_s is not None and h["alive"] and
                  h["scheduler_running"] and h["warm"] and
                  (h["active_slots"] or h["queue_depth"]) and
                  h["progress_age_s"] > self.stall_timeout_s):
                flight.record("supervisor", "stall", engine=self.name,
                              progress_age_s=round(h["progress_age_s"], 3))
                eng.abandon(EngineStalledError(
                    f"engine {self.name!r}: no scheduler progress for "
                    f"{h['progress_age_s']:.2f}s with work pending "
                    f"(stall_timeout_s={self.stall_timeout_s})"))
                self._restart(eng)
            self._wake_ev.wait(self.poll_interval_s)
            self._wake_ev.clear()

    def _restart(self, old: Engine):
        """Shut the dead engine down, build another, re-enqueue the parked
        requests."""
        now = time.monotonic()
        with self._lock:
            if self._failed is not None or self._stop_ev.is_set():
                return
            self._restart_times = [t for t in self._restart_times
                                   if now - t < self.restart_window_s]
            over_budget = len(self._restart_times) >= self.max_restarts
            if over_budget:
                self._failed = RuntimeError(
                    f"supervisor {self.name!r}: restart budget exhausted "
                    f"({self.max_restarts} restarts in "
                    f"{self.restart_window_s:g}s)")
                parked, self._parked = self._parked, []
            else:
                self._restart_times.append(now)
                self._restarting = True
                if not getattr(old, "_supervisor_retired", False):
                    old._supervisor_retired = True
                    self._build_stats.append(old.compile_stats())
        if over_budget:
            cause = old._dead or self._failed
            flight.record("supervisor", "giveup", engine=self.name,
                          failed_requests=len(parked),
                          requests=",".join(str(r.request_id)
                                            for r in parked),
                          error=f"{type(cause).__name__}: {cause}")
            for req in parked:
                req._finish(EngineDeadError(cause))
            return
        flight.record("supervisor", "teardown", engine=self.name,
                      error=(None if old._dead is None
                             else f"{type(old._dead).__name__}: "
                                  f"{old._dead}"))
        try:
            old.shutdown()
        except Exception:  # noqa: BLE001 — the old engine is expendable
            pass
        try:
            faults.fault_point("serving.rebuild", engine=self.name)
            new = self._attach(self.factory())
        except Exception as e:  # noqa: BLE001 — the next poll sees the
            # engine still dead and retries, within the budget
            flight.record("supervisor", "rebuild_failed", engine=self.name,
                          error=f"{type(e).__name__}: {e}")
            with self._lock:
                self._restarting = False
            return
        with self._lock:
            self._engine = new
            parked, self._parked = self._parked, []
            self._restarting = False
            self._restarts += 1
            restarts = self._restarts
        requeued = []
        for req in parked:
            try:
                new.resubmit(req)
                requeued.append(req.request_id)
                if req.journey is not None:
                    # the death -> rebuilt-engine window: the SAME journey
                    # id keeps accumulating phases on the fresh build
                    t_park = req._park_t0 or time.perf_counter()
                    req.journey.phase(
                        "rebuild", t_park, time.perf_counter() - t_park,
                        engine=self.name, restart=restarts)
            except Exception as e:  # noqa: BLE001 — never strand a handle
                req._finish(e if isinstance(e, EngineDeadError)
                            else EngineDeadError(e))
        with self._lock:
            self._redispatched += len(requeued)
        try:
            new.start()
        except Exception:  # noqa: BLE001 — died at once; the next poll
            pass           # retries
        registry().counter(
            SERVING_RESTARTS,
            "engine rebuilds performed by a supervisor").inc(
            1.0, labels={"engine": self.name})
        flight.record("supervisor", "restart", engine=self.name,
                      restarts=restarts, redispatched=len(requeued),
                      requests=",".join(map(str, requeued)))

    # -- engine-shaped surface -----------------------------------------------
    @property
    def engine(self) -> Engine:
        """The current build (changes across restarts)."""
        with self._lock:
            return self._engine

    @property
    def tokenizer(self):
        return self.engine.tokenizer

    @property
    def adapter_registry(self):
        """The persistent adapter registry (the factory hands the same one
        to every build; only residency is fresh)."""
        return self.engine.adapter_registry

    @property
    def max_len(self) -> int:
        return self.engine.max_len

    @property
    def max_slots(self) -> int:
        return self.engine.max_slots

    @property
    def restarts(self) -> int:
        with self._lock:
            return self._restarts

    @property
    def redispatched(self) -> int:
        with self._lock:
            return self._redispatched

    @property
    def failed(self) -> Optional[BaseException]:
        with self._lock:
            return self._failed

    def builds(self) -> List[dict]:
        """``compile_stats()`` of every retired build and the current one
        (each build captures one decode graph)."""
        with self._lock:
            eng = self._engine
            out = list(self._build_stats)
        out.append(eng.compile_stats())
        return out

    def submit(self, *args, **kwargs):
        with self._lock:
            eng, failed = self._engine, self._failed
        if failed is not None:
            raise EngineDeadError(failed)
        try:
            return eng.submit(*args, **kwargs)
        except EngineDeadError:
            if self.failed is not None:
                raise
            # between death and rebuild: backpressure, not a permanent
            # failure — callers retry as for a full queue
            raise QueueFullError(
                f"engine {self.name!r} is restarting; retry shortly") \
                from None

    def load(self) -> dict:
        with self._lock:
            eng, failed, stopped = (self._engine, self._failed,
                                    self._stop_ev.is_set())
        ld = eng.load()
        if failed is not None or stopped:
            ld["alive"] = False
        elif not ld["alive"] and not ld["draining"] and eng.health()["dead"]:
            # dead but supervised: the rebuild is imminent — alive with
            # no headroom, so a router waits instead of giving up
            ld.update(alive=True, restarting=True,
                      slots_in_use=ld["max_slots"],
                      queue_depth=ld["max_queue"])
        return ld

    def health(self) -> dict:
        with self._lock:
            eng, failed, restarting = (self._engine, self._failed,
                                       self._restarting)
            restarts, stopped = self._restarts, self._stop_ev.is_set()
        h = eng.health()
        h["supervised"] = True
        h["restarts"] = restarts
        h["restarting"] = restarting or (
            h["dead"] and failed is None and not stopped)
        if failed is not None:
            h["alive"] = False
            h["supervisor_failed"] = f"{type(failed).__name__}: {failed}"
        return h

    def stats(self) -> dict:
        return self.engine.stats()

    def compile_stats(self) -> dict:
        return self.engine.compile_stats()

    def queue_depth(self) -> int:
        return self.engine.queue_depth()

    def slots_in_use(self) -> int:
        return self.engine.slots_in_use()

    def adapter_resident(self, name: str) -> bool:
        return self.engine.adapter_resident(name)

    def join(self, timeout: Optional[float] = None) -> bool:
        return self.engine.join(timeout)

    def drain(self, deadline_s: float = 30.0) -> bool:
        """Drain the current engine (the graceful end of the replica)."""
        return self.engine.drain(deadline_s)

    def undrain(self):
        return self.engine.undrain()

    def shutdown(self):
        """Stop supervising and shut the current engine down; parked
        requests fail with ``EngineClosedError``."""
        self._stop_ev.set()
        self._wake_ev.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
        with self._lock:
            eng = self._engine
            parked, self._parked = self._parked, []
        err = EngineClosedError("supervisor shut down")
        for req in parked:
            req._finish(err)
        eng.shutdown()

    close = shutdown

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    def __repr__(self):
        with self._lock:
            state = ("failed" if self._failed is not None else
                     "restarting" if self._restarting else "ok")
        return (f"EngineSupervisor(name={self.name!r}, state={state}, "
                f"restarts={self.restarts})")
