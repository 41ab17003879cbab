"""Autoscaler — closed-loop fleet elasticity over supervised replicas.

The port's copy of ``paddle_tpu/serving/autoscaler.py``: the same policy,
decisions, flight events, metric names and ``/debug/fleet`` block.  The
supervisor's factory rebuilds engines, the router tracks per-replica
``load()`` and takes membership changes at runtime, the shedder estimates
TTFT from EWMAs, drain is graceful end to end, and
``Gateway.window_stats()`` is the telemetry feed.  The
:class:`Autoscaler` watches that feed from a control thread and turns it
into replica count:

* **scale up** when the TTFT-estimate headroom collapses against the
  SLO, the windowed queue-wait p99 breaches, or the shed rate is
  sustained — a worker thread builds a fresh replica through the
  caller's ``factory`` (the ``scale.up_build`` fault seam; a build that
  dies is retried) and adds it to the router the moment it is ready.
* **scale down** on sustained idle — and scale-down is ALWAYS
  ``drain(deadline)`` → wait → ``remove_replica`` → teardown, never a
  kill: the draining replica is unpickable (the router's third state)
  while its in-flight work finishes, and only an empty replica leaves
  the fleet (``scale.down_drain`` seam; a replica that dies mid-drain is
  absorbed — its supervisor heals it and the drain is retried).
* **hysteresis + per-direction cooldowns** in :class:`ScalePolicy` keep
  the fleet from flapping: an up decision needs ``up_ticks`` consecutive
  breach polls, a down needs ``idle_ticks`` idle polls, and both
  directions refuse to fire inside the other's cooldown window.

Every decision is a flight event (``kind="autoscaler"``) and a
``paddle_tpu_fleet_scale_events_total{direction,reason}`` increment;
``paddle_tpu_fleet_replicas_{desired,alive,draining}`` gauges and
``GET /debug/fleet`` expose the fleet state.

**Simulation mode** (:class:`FleetSim`): the same :class:`ScalePolicy`
object drives virtual replicas through the shedder's latency model
(``prefill_s + token_s * backlog/slots``) in virtual time — no devices,
no sleeping — so scaling policy (flap resistance, drain deadlines, SLO
attainment vs replica-seconds on a flash-crowd trace) is testable on the
CPU and benchable as a closed-loop curve instead of fixed-QPS points.

The fleet's metric names are defined here once; the gateway's router
imports ``FLEET_ALIVE`` from this module.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

import numpy as np

from ..observability import flight, registry
from ..testing import faults

__all__ = ["ScalePolicy", "Autoscaler", "FleetSim",
           "FLEET_DESIRED", "FLEET_ALIVE", "FLEET_DRAINING",
           "FLEET_SCALE_EVENTS"]

FLEET_DESIRED = "paddle_tpu_fleet_replicas_desired"
FLEET_ALIVE = "paddle_tpu_fleet_replicas_alive"
FLEET_DRAINING = "paddle_tpu_fleet_replicas_draining"
FLEET_SCALE_EVENTS = "paddle_tpu_fleet_scale_events_total"


class ScalePolicy:
    """Pure decision function over the windowed telemetry feed.

    Stateful only in its streak counters and event stamps, and fed
    explicit ``now`` timestamps, so the SAME object drives the live
    control loop and the virtual-time simulator — and unit tests replay
    synthetic window feeds against it directly.

    Scale-up triggers (any, sustained for ``up_ticks`` polls):

    * ``ttft_headroom`` — the shedder's TTFT estimate ate the SLO
      headroom: ``est_ttft_s > (1 - headroom_frac) * slo_ttft_s``.
    * ``queue_wait_p99`` — windowed fair-share queue wait p99 breach.
    * ``shed_rate`` — sustained shedding (the fleet is rejecting work
      it should be absorbing).
    * ``slo_alert`` — (opt-in, ``scale_on_alerts=True``) the SLO
      engine's firing set is non-empty: the feed's optional
      ``firing_alerts`` field carries the burn-rate alerts a
      :class:`~paddle_tpu_torch.observability.slo.SloEvaluator` is
      firing — the seam for SLO-class-aware scaling.

    Scale-down trigger (sustained for ``idle_ticks`` polls): queue
    empty, slot utilization at most ``idle_util``, no shedding, and the
    TTFT estimate comfortably inside the SLO (below ``idle_est_frac *
    slo_ttft_s``) — the hysteresis band between the up and down
    thresholds is what keeps a borderline fleet stable.

    Both directions carry a cooldown, and each direction also refuses
    to fire inside the OTHER's window (no up→down→up flap inside one
    cooldown).
    """

    def __init__(self, *, slo_ttft_s: float = 2.0,
                 headroom_frac: float = 0.25,
                 queue_wait_p99_s: float = 1.0,
                 shed_rate: float = 0.05,
                 up_ticks: int = 2, idle_ticks: int = 8,
                 idle_util: float = 0.25, idle_est_frac: float = 0.3,
                 cooldown_up_s: float = 10.0,
                 cooldown_down_s: float = 30.0,
                 min_window_requests: int = 1,
                 scale_on_alerts: bool = False):
        if not 0 < headroom_frac < 1 or not 0 < idle_est_frac < 1:
            raise ValueError("headroom_frac/idle_est_frac must be in (0,1)")
        self.slo_ttft_s = float(slo_ttft_s)
        self.headroom_frac = float(headroom_frac)
        self.queue_wait_p99_s = float(queue_wait_p99_s)
        self.shed_rate = float(shed_rate)
        self.up_ticks = int(up_ticks)
        self.idle_ticks = int(idle_ticks)
        self.idle_util = float(idle_util)
        self.idle_est_frac = float(idle_est_frac)
        self.cooldown_up_s = float(cooldown_up_s)
        self.cooldown_down_s = float(cooldown_down_s)
        self.min_window_requests = int(min_window_requests)
        self.scale_on_alerts = bool(scale_on_alerts)
        self._up_streak = 0
        self._idle_streak = 0
        self._last_up = float("-inf")
        self._last_down = float("-inf")

    # -- the decision ---------------------------------------------------------
    def breach_reason(self, feed: dict) -> str:
        """Which scale-up trigger (if any) the feed is breaching."""
        # a firing burn-rate alert already encodes target + hysteresis;
        # honouring it first lets per-class SLOs drive scale directly
        if self.scale_on_alerts and feed.get("firing_alerts"):
            return "slo_alert"
        est = feed.get("est_ttft_s")
        thresh = (1.0 - self.headroom_frac) * self.slo_ttft_s
        # a breach the fleet can actually fix: replicas drain backlog,
        # so est can at best fall to the prefill floor — if the floor
        # itself blows the threshold (cold-capture-contaminated EWMA,
        # or a genuinely unattainable SLO), adding chips changes
        # nothing and the fleet must stay free to scale DOWN
        if est is not None and est > thresh and \
                (feed.get("prefill_s") or 0.0) <= thresh:
            return "ttft_headroom"
        qw = feed.get("queue_wait_s") or {}
        if qw.get("n", 0) >= self.min_window_requests and \
                qw.get("p99", 0.0) > self.queue_wait_p99_s:
            return "queue_wait_p99"
        traffic = feed.get("requests", 0) + feed.get("shed", 0)
        if traffic >= self.min_window_requests and \
                feed.get("shed_rate", 0.0) >= self.shed_rate:
            return "shed_rate"
        return ""

    def is_idle(self, feed: dict) -> bool:
        util = feed.get("slots_in_use", 0) / max(1, feed.get(
            "total_slots", 1))
        est = feed.get("est_ttft_s")
        # judge the BACKLOG component of the estimate, not the prefill
        # floor: an idle fleet's est_ttft is exactly the prefill EWMA
        # (which early cold-capture observations inflate for a while),
        # and a fleet with zero backlog must still be able to shrink
        backlog_s = (None if est is None
                     else est - (feed.get("prefill_s") or 0.0))
        return (feed.get("queue_depth", 0) == 0 and
                util <= self.idle_util and
                feed.get("shed_rate", 0.0) == 0.0 and
                (backlog_s is None or
                 backlog_s < self.idle_est_frac * self.slo_ttft_s))

    def decide(self, feed: dict, *, replicas: int, min_replicas: int,
               max_replicas: int, now: float) -> tuple:
        """(direction, reason): ("up"/"down", trigger) or (None, "")."""
        reason = self.breach_reason(feed)
        if reason:
            self._up_streak += 1
            self._idle_streak = 0
        elif self.is_idle(feed):
            self._idle_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = 0
            self._idle_streak = 0
        if reason and self._up_streak >= self.up_ticks and \
                replicas < max_replicas and \
                now - self._last_up >= self.cooldown_up_s and \
                now - self._last_down >= self.cooldown_up_s:
            return "up", reason
        if self._idle_streak >= self.idle_ticks and \
                replicas > min_replicas and \
                now - self._last_down >= self.cooldown_down_s and \
                now - self._last_up >= self.cooldown_down_s:
            return "down", "idle"
        return None, ""

    def note_event(self, direction: str, now: float):
        """Stamp a scale event (the autoscaler calls this when an op
        STARTS, the simulator when one applies): streaks reset, the
        cooldown clocks restart."""
        if direction == "up":
            self._last_up = now
        else:
            self._last_down = now
        self._up_streak = 0
        self._idle_streak = 0

    def snapshot(self) -> dict:
        return {
            "slo_ttft_s": self.slo_ttft_s,
            "headroom_frac": self.headroom_frac,
            "queue_wait_p99_s": self.queue_wait_p99_s,
            "shed_rate": self.shed_rate,
            "up_ticks": self.up_ticks, "idle_ticks": self.idle_ticks,
            "idle_util": self.idle_util,
            "cooldown_up_s": self.cooldown_up_s,
            "cooldown_down_s": self.cooldown_down_s,
            "scale_on_alerts": self.scale_on_alerts,
            "up_streak": self._up_streak, "idle_streak": self._idle_streak,
        }


class Autoscaler:
    """Control loop: gateway telemetry in, replica membership out.

    Args:
        stack: the :class:`~paddle_tpu_torch.serving.gateway.Gateway` (or a
            ``GatewayStack`` — its ``.gateway`` is used) whose
            ``window_stats()`` feed and router this loop drives.
        factory: zero-arg callable returning a fresh Engine-shaped
            replica (an ``Engine``, or an ``EngineSupervisor`` for
            self-healing replicas — the production shape).  Called from
            the scale worker thread; a raise fails that scale-up, which
            is retried.  Replicas may share one model's weights: each
            engine captures its own decode graph on its own stream.
        min_replicas / max_replicas: hard fleet bounds; scale decisions
            clamp to them, and scale-down never drains the fleet below
            ``min_replicas``.
        policy: a :class:`ScalePolicy` (default one is built).
        poll_interval_s: control-thread poll period.
        drain_deadline_s: per-attempt deadline handed to
            ``replica.drain()`` during scale-down; drain is retried (a
            replica that died mid-drain was healed by its supervisor)
            until the replica is empty — scale-down NEVER kills.
        build_s_hint: seed for the cold-build EWMA before the first
            in-loop build completes (the shedder's Retry-After cap uses
            this to tell shed clients when capacity will arrive).
        name_prefix: replica names are ``{prefix}-s{N}`` with a
            monotone N (never reused, so per-engine metric series never
            collide across builds).
        warm_pool: parked standby replicas.  With ``warm_pool=1`` a
            background worker keeps one replica BUILT, PREWARMED (its
            decode graph captured) and PARKED-DRAINING (``load()`` advertises
            not-alive, so it refuses work on the shelf): a flash
            scale-up routes the spare in instead of cold-building —
            reaction time is a route-in, not the cold-build EWMA — and
            a refill build starts in the background.  Spares follow the
            rollout controller's revision: a rollout upgrades the shelf
            too (stale-revision spares are torn down, never routed in).
    """

    def __init__(self, stack, factory: Callable[[], object], *,
                 min_replicas: int = 1, max_replicas: int = 4,
                 policy: Optional[ScalePolicy] = None,
                 poll_interval_s: float = 1.0,
                 drain_deadline_s: float = 30.0,
                 build_s_hint: float = 10.0,
                 name_prefix: str = "engine", warm_pool: int = 0,
                 start: bool = True):
        gateway = getattr(stack, "gateway", stack)
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        self.gateway = gateway
        self.factory = factory
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.policy = policy or ScalePolicy()
        self.poll_interval_s = float(poll_interval_s)
        self.drain_deadline_s = float(drain_deadline_s)
        self.name_prefix = str(name_prefix)
        self.warm_pool = int(warm_pool)
        self._lock = threading.Lock()
        self._stop_ev = threading.Event()
        self._wake_ev = threading.Event()
        self._op: Optional[dict] = None      # the in-flight scale op
        self._pending: Optional[tuple] = None  # (direction, reason) retry
        self._replica_n = 0
        self._build_ewma_s = float(build_s_hint)
        self._builds = 0
        self._events: deque = deque(maxlen=64)
        self._desired = len(gateway.router.names)
        self._warm: list = []           # parked (name, engine, revision)
        self._warm_building = False
        self._warm_n = 0
        self._thread: Optional[threading.Thread] = None
        self._workers: list = []        # scale and warm-build threads
        gateway.attach_autoscaler(self)
        if start:
            self.start()

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        if self._stop_ev.is_set():
            raise RuntimeError("autoscaler is shut down")
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._thread = threading.Thread(
                target=self._run, name="paddle-tpu-autoscaler", daemon=True)
            self._thread.start()

    def shutdown(self, timeout_s: float = 150.0):
        """Stop the control loop, join its scale and warm-build workers
        (a build in flight finishes; an unparked spare is torn down) and
        tear down parked spares (routed replicas stay as they are — the
        stack owns their teardown)."""
        self._stop_ev.set()
        self._wake_ev.set()
        with self._lock:
            th = self._thread
        if th is not None:
            th.join(timeout=10)
        with self._lock:
            workers, self._workers = self._workers, []
        deadline = time.monotonic() + timeout_s
        for w in workers:
            w.join(timeout=max(0.0, deadline - time.monotonic()))
        self.drop_warm_pool(reason="shutdown")

    close = shutdown

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- control thread ------------------------------------------------------
    def _run(self):
        while not self._stop_ev.is_set():
            try:
                faults.fault_point("autoscaler.tick")
                self._tick()
            except Exception as e:  # noqa: BLE001 — a bad tick must not
                # kill the loop: the fleet would silently stop scaling.
                # Record it loudly and keep polling (the chaos matrix
                # crashes this seam on purpose).
                flight.record("autoscaler", "tick_error",
                              error=f"{type(e).__name__}: {e}")
            self._wake_ev.wait(self.poll_interval_s)
            self._wake_ev.clear()

    def _tick(self):
        gw = self.gateway
        loads = gw.router.loads()
        alive = sum(1 for ld in loads.values()
                    if ld["alive"] and not ld.get("draining"))
        draining = sum(1 for ld in loads.values() if ld.get("draining"))
        feed = gw.window_stats()
        feed["slots_in_use"] = sum(ld["slots_in_use"]
                                   for ld in loads.values())
        feed["total_slots"] = gw.router.total_slots()
        feed["prefill_s"] = gw.shedder.snapshot()["prefill_s"]
        # the SLO engine's firing set rides the policy feed (optional:
        # [] when no engine is attached) — ScalePolicy(scale_on_alerts=
        # True) scales on it, every policy sees it for introspection
        slo = getattr(gw, "slo_engine", None)
        feed["firing_alerts"] = slo.firing() if slo is not None else []
        with self._lock:
            op = self._op
            pending = None
            if op is None:
                # a queued event waits out the op in flight (one scale op
                # at a time) instead of being dropped
                pending, self._pending = self._pending, None
            desired = self._desired
        self._gauges(desired, alive, draining)
        self._maybe_refill_warm()
        if op is not None:
            return                       # one scale op at a time
        now = time.monotonic()
        if pending is not None:
            direction, reason = pending
        else:
            direction, reason = self.policy.decide(
                feed, replicas=alive, min_replicas=self.min_replicas,
                max_replicas=self.max_replicas, now=now)
        if direction == "up" and alive + draining < self.max_replicas:
            self._start_op("up", reason, now)
        elif direction == "down" and alive > self.min_replicas:
            self._start_op("down", reason, now)

    def _gauges(self, desired: int, alive: int, draining: int):
        reg = registry()
        reg.gauge(FLEET_DESIRED, "replica count the autoscaler wants").set(
            float(desired))
        reg.gauge(FLEET_ALIVE, "alive, non-draining replicas").set(
            float(alive))
        reg.gauge(FLEET_DRAINING, "replicas draining for scale-down").set(
            float(draining))

    def _start_op(self, direction: str, reason: str, now: float):
        self.policy.note_event(direction, now)
        op = {"direction": direction, "reason": reason,
              "t0": time.monotonic()}
        with self._lock:
            self._op = op
            self._desired += 1 if direction == "up" else -1
            self._desired = max(self.min_replicas,
                                min(self.max_replicas, self._desired))
        self._spawn(self._scale_worker, f"paddle-tpu-scale-{direction}",
                    (direction, reason))

    def _spawn(self, target, name: str, args=()):
        """Start a worker thread that :meth:`shutdown` joins."""
        worker = threading.Thread(target=target, args=args, name=name,
                                  daemon=True)
        with self._lock:
            self._workers = [w for w in self._workers if w.is_alive()]
            self._workers.append(worker)
        worker.start()

    # -- scale worker --------------------------------------------------------
    def _scale_worker(self, direction: str, reason: str):
        try:
            if direction == "up":
                self._scale_up(reason)
            else:
                self._scale_down(reason)
        except Exception as e:  # noqa: BLE001 — a scale op that died is
            # ABSORBED, never fatal: undo the desired-count move, count
            # it, and queue a retry for the next tick (the crash matrix
            # raises inside both seams on purpose)
            flight.record("autoscaler", f"scale_{direction}_failed",
                          reason=reason, error=f"{type(e).__name__}: {e}")
            registry().counter(
                FLEET_SCALE_EVENTS, "scale events by direction/reason").inc(
                1.0, labels={"direction": f"{direction}_failed",
                             "reason": reason})
            with self._lock:
                self._desired += -1 if direction == "up" else 1
                self._pending = (direction, reason)   # retry next tick
        finally:
            with self._lock:
                self._op = None
            self._wake_ev.set()

    def _scale_up(self, reason: str):
        spare = self._pop_warm()
        if spare is not None:
            name, engine, rev = spare
            flight.record("autoscaler", "scale_up_warm_begin",
                          replica=name, reason=reason)
            t0 = time.monotonic()
            # route-in, not a build: un-park (reverse the shelf drain)
            # and add to the router — reaction is milliseconds, so the
            # cold-build EWMA is NOT fed (it must keep measuring builds)
            undrain = getattr(engine, "undrain", None)
            if undrain is not None:
                undrain()
            self.gateway.router.add_replica(name, engine, revision=rev)
            route_s = time.monotonic() - t0
            with self._lock:
                self._events.append({
                    "t": time.time(), "direction": "up", "reason": reason,
                    "replica": name, "ms": round(route_s * 1e3, 1),
                    "warm": True})
            registry().counter(
                FLEET_SCALE_EVENTS, "scale events by direction/reason").inc(
                1.0, labels={"direction": "up", "reason": reason})
            flight.record("autoscaler", "scale_up_warm", replica=name,
                          reason=reason,
                          route_in_ms=round(route_s * 1e3, 1))
            self._wake_ev.set()          # refill the shelf promptly
            return
        rev, factory = self._current_factory()
        with self._lock:
            self._replica_n += 1
            name = f"{self.name_prefix}-s{self._replica_n}"
        flight.record("autoscaler", "scale_up_begin", replica=name,
                      reason=reason)
        t0 = time.monotonic()
        faults.fault_point("scale.up_build", replica=name)
        engine = factory()
        self.gateway.router.add_replica(name, engine, revision=rev)
        self._await_warm(engine)
        build_s = time.monotonic() - t0
        with self._lock:
            self._builds += 1
            a = 0.5 if self._builds > 1 else 1.0
            self._build_ewma_s = (1 - a) * self._build_ewma_s + a * build_s
            self._events.append({
                "t": time.time(), "direction": "up", "reason": reason,
                "replica": name, "ms": round(build_s * 1e3, 1)})
        registry().counter(
            FLEET_SCALE_EVENTS, "scale events by direction/reason").inc(
            1.0, labels={"direction": "up", "reason": reason})
        flight.record("autoscaler", "scale_up", replica=name,
                      reason=reason, build_ms=round(build_s * 1e3, 1))

    def _current_factory(self) -> tuple:
        """(revision, zero-arg factory) for the next cold build.  While
        a rollout controller is attached, builds follow ITS revision —
        the mid-rollout target, or the fleet's post-upgrade revision —
        so elasticity never resurrects a superseded build; without one,
        the constructor's factory at the fleet's revision."""
        ctl = getattr(self.gateway, "rollout", None)
        if ctl is not None:
            return ctl.revision(), ctl.factory()
        revs = self.gateway.router.revisions()
        return next(iter(revs.values()), "r0"), self.factory

    def _await_warm(self, engine, timeout_s: float = 120.0):
        """Hold the scale-up op open until the new replica is WARM (its
        decode graph captured) — "warm-up completion" is what the
        cold-build EWMA must measure, because that is when shed clients
        can actually be served.  Returns early when the fleet went idle
        (no traffic will warm the replica) or the engine has no health
        surface (router stubs in tests)."""
        health = getattr(engine, "health", None)
        if health is None:
            return
        deadline = time.monotonic() + timeout_s
        while not self._stop_ev.is_set() and time.monotonic() < deadline:
            try:
                h = health()
            except Exception:  # noqa: BLE001 — treat as not warmable
                return
            if h.get("warm") or h.get("dead"):
                return
            ld = engine.load()
            if self.gateway.scheduler.depth() == 0 and \
                    ld["queue_depth"] == 0 and ld["slots_in_use"] == 0:
                return                  # breach evaporated: nothing to warm
            time.sleep(0.05)

    def _pick_victim(self):
        """(name, engine) with the least load among removable replicas
        (alive, not draining, not the last ``min_replicas``).  While a
        rollout is active its target-revision replicas — the canary and
        the surge builds — are PROTECTED: scaling one of them down
        would unwind the upgrade mid-flight."""
        router = self.gateway.router
        loads = router.loads()
        alive = [n for n, ld in loads.items()
                 if ld["alive"] and not ld.get("draining")]
        if len(alive) <= self.min_replicas:
            return None
        ctl = getattr(self.gateway, "rollout", None)
        protected = ctl.protected() if ctl is not None else frozenset()
        candidates = [n for n in alive if n not in protected]
        if not candidates:
            return None
        victim = min(candidates, key=lambda n: (loads[n]["slots_in_use"] +
                                                loads[n]["queue_depth"], n))
        engines = dict(zip(router.names, router.engines))
        eng = engines.get(victim)
        return (victim, eng) if eng is not None else None

    def _scale_down(self, reason: str):
        picked = self._pick_victim()
        if picked is None:
            with self._lock:
                self._desired += 1
            return
        name, eng = picked
        flight.record("autoscaler", "scale_down_begin", replica=name,
                      reason=reason)
        t0 = time.monotonic()
        faults.fault_point("scale.down_drain", replica=name)
        # drain-before-remove, retried until EMPTY: a replica that dies
        # mid-drain is healed by its supervisor (the rebuilt engine is
        # not draining), so we re-issue the drain against the current
        # build — scale-down never kills in-flight work
        attempts = 0
        while not self._stop_ev.is_set():
            attempts += 1
            if eng.drain(self.drain_deadline_s):
                break
            flight.record("autoscaler", "drain_retry", replica=name,
                          attempt=attempts)
            # a drain that returns False INSTANTLY (the replica died
            # and its supervisor is mid-rebuild, or a never-warmed
            # engine is settling) must not spin this worker hot
            self._stop_ev.wait(min(0.05 * attempts, 0.5))
        else:
            with self._lock:
                self._desired += 1
            return                      # shut down mid-drain: leave it
        try:
            self.gateway.router.remove_replica(name)
        except (KeyError, ValueError) as e:
            # raced a concurrent removal or the fleet shrank under us:
            # the drain already emptied the replica, just tear it down
            flight.record("autoscaler", "remove_raced", replica=name,
                          error=f"{type(e).__name__}: {e}")
        try:
            eng.shutdown()              # teardown releases ledger rows
        except Exception:  # noqa: BLE001 — the replica is already empty
            pass
        drain_s = time.monotonic() - t0
        with self._lock:
            self._events.append({
                "t": time.time(), "direction": "down", "reason": reason,
                "replica": name, "ms": round(drain_s * 1e3, 1)})
        registry().counter(
            FLEET_SCALE_EVENTS, "scale events by direction/reason").inc(
            1.0, labels={"direction": "down", "reason": reason})
        flight.record("autoscaler", "scale_down", replica=name,
                      reason=reason, drain_ms=round(drain_s * 1e3, 1),
                      drain_attempts=attempts)

    # -- warm pool ------------------------------------------------------------
    def _maybe_refill_warm(self):
        """Kick the background refill when the shelf is short (one
        refill build at a time; every control-loop tick checks)."""
        if self.warm_pool <= 0:
            return
        with self._lock:
            if self._warm_building or len(self._warm) >= self.warm_pool:
                return
            self._warm_building = True
        self._spawn(self._warm_build_worker, "paddle-tpu-warm-pool")

    def _warm_build_worker(self):
        eng = None
        try:
            rev, factory = self._current_factory()
            with self._lock:
                self._warm_n += 1
                name = f"{self.name_prefix}-w{self._warm_n}"
            t0 = time.monotonic()
            eng = factory()
            self._prewarm(eng)
            try:
                # park: the shelf drain makes load() advertise
                # not-alive, so the spare refuses work until routed in
                eng.drain(0.5)
            except Exception:  # noqa: BLE001 — stubs without drain park as-is
                pass
            with self._lock:
                parked = (not self._stop_ev.is_set() and
                          len(self._warm) < self.warm_pool)
                if parked:
                    self._warm.append((name, eng, rev))
            if not parked:
                try:
                    eng.shutdown()
                except Exception:  # noqa: BLE001 — never routed
                    pass
                return
            flight.record("autoscaler", "warm_park", replica=name,
                          revision=rev,
                          build_ms=round((time.monotonic() - t0) * 1e3, 1))
        except Exception as e:  # noqa: BLE001 — a failed refill is
            # absorbed (the build is torn down, never parked); the next
            # tick retries it
            flight.record("autoscaler", "warm_build_failed",
                          error=f"{type(e).__name__}: {e}")
            if eng is not None:
                try:
                    eng.shutdown()
                except Exception:  # noqa: BLE001 — never routed
                    pass
        finally:
            with self._lock:
                self._warm_building = False

    @staticmethod
    def _prewarm(eng):
        """Capture the spare's decode graph BEFORE parking — a spare that
        still owes its capture would make the warm route-in a lie.  A
        replica without the engine surface (a router stub) parks as it
        is; an engine whose warm-up request fails, or that does not end
        it with exactly one captured decode graph, raises: a failed
        build, never a parked one."""
        submit = getattr(eng, "submit", None)
        compile_stats = getattr(eng, "compile_stats", None)
        if submit is None or compile_stats is None:
            return
        submit(np.arange(1, 5, dtype=np.int64),
               max_new_tokens=2).result(timeout=120)
        n = int(compile_stats()["decode_compiles"])
        if n != 1:
            raise RuntimeError(f"prewarm ended with {n} captured decode "
                               f"graphs (want 1)")

    def _pop_warm(self):
        """The first parked spare at the fleet's CURRENT target
        revision; stale-revision spares found on the way are torn down
        (an old build must never route into an upgraded fleet)."""
        if self.warm_pool <= 0:
            return None
        ctl = getattr(self.gateway, "rollout", None)
        want = ctl.revision() if ctl is not None else None
        picked = None
        stale = []
        with self._lock:
            keep = []
            for item in self._warm:
                if want is not None and item[2] != want:
                    stale.append(item)
                elif picked is None:
                    picked = item
                else:
                    keep.append(item)
            self._warm = keep
        for name, eng, rev in stale:
            flight.record("autoscaler", "warm_drop", replica=name,
                          revision=rev, reason="stale_revision")
            try:
                eng.shutdown()
            except Exception:  # noqa: BLE001 — never routed
                pass
        return picked

    def drop_warm_pool(self, keep_revision: Optional[str] = None,
                       reason: str = "rollout"):
        """Tear down parked spares NOT at ``keep_revision`` (the
        rollout controller calls this after an upgrade, so the shelf
        refills at the new revision; ``None`` drops everything)."""
        with self._lock:
            keep, drop = [], []
            for item in self._warm:
                (keep if (keep_revision is not None and
                          item[2] == keep_revision) else drop).append(item)
            self._warm = keep
        for name, eng, rev in drop:
            flight.record("autoscaler", "warm_drop", replica=name,
                          revision=rev, reason=reason)
            try:
                eng.shutdown()
            except Exception:  # noqa: BLE001 — never routed
                pass
        if drop:
            self._wake_ev.set()          # refill promptly

    # -- operator / gateway surface ------------------------------------------
    def trigger(self, direction: str, reason: str = "manual"):
        """Queue one scale event for the next tick (operator nudge; the
        chaos lane uses it to schedule kills DURING scale events)."""
        if direction not in ("up", "down"):
            raise ValueError("direction must be 'up' or 'down'")
        with self._lock:
            self._pending = (direction, reason)
        self._wake_ev.set()

    def scale_pending(self) -> bool:
        """True while a scale-UP is building or queued — the gateway
        treats this as capacity-on-the-way (no all-dead 503 while the
        only other replica drains)."""
        with self._lock:
            return ((self._op is not None and
                     self._op["direction"] == "up") or
                    (self._pending is not None and
                     self._pending[0] == "up"))

    def expected_ready_s(self) -> Optional[float]:
        """Expected seconds until the in-flight scale-up's replica takes
        traffic (cold-build EWMA minus elapsed build time); None when no
        scale-up is in flight.  The LoadShedder caps 429 ``Retry-After``
        at this, so shed clients come back when capacity arrives."""
        with self._lock:
            if self._op is not None and self._op["direction"] == "up":
                elapsed = time.monotonic() - self._op["t0"]
                return max(0.1, self._build_ewma_s - elapsed)
            if self._pending is not None and self._pending[0] == "up":
                return max(0.1, self._build_ewma_s)
        return None

    @property
    def desired(self) -> int:
        with self._lock:
            return self._desired

    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def fleet_stats(self) -> dict:
        """The ``/debug/fleet`` payload: bounds, desired count, the
        in-flight op, the cold-build EWMA, recent scale events and the
        policy's threshold snapshot."""
        with self._lock:
            op = dict(self._op) if self._op is not None else None
            out = {
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "desired": self._desired,
                "build_ewma_s": round(self._build_ewma_s, 3),
                "builds": self._builds,
                "events": list(self._events),
                "warm_pool": {
                    "size": self.warm_pool,
                    "building": self._warm_building,
                    "parked": [{"replica": n, "revision": r}
                               for n, _, r in self._warm]},
            }
        if op is not None:
            op["elapsed_s"] = round(time.monotonic() - op.pop("t0"), 3)
        out["op"] = op
        out["policy"] = self.policy.snapshot()
        return out


# -- simulation mode ----------------------------------------------------------

class _SimReplica:
    __slots__ = ("name", "state", "ready_at", "active", "born_at")

    def __init__(self, name, state, now, ready_at=0.0):
        self.name = name
        self.state = state            # "building" | "up" | "draining"
        self.ready_at = ready_at
        self.active: list = []        # [(finish_t, ttft_ok)] in-flight
        self.born_at = now


class FleetSim:
    """Virtual-time closed loop: the shedder's latency model against
    virtual replicas, driven by the SAME :class:`ScalePolicy` the live
    autoscaler runs — no devices, no wall-clock sleeping, deterministic
    for a seeded trace.

    Service model (the shed formula, applied literally): a request
    occupies one slot for ``prefill_s + max_tokens * token_s``; TTFT =
    queue wait + ``prefill_s``; admission sheds a deadline-carrying
    request when ``prefill_s + token_s * backlog_tokens / total_slots``
    blows its deadline.  Builds take ``build_s`` of virtual time (a
    building replica burns replica-seconds but serves nothing); a
    draining replica finishes its in-flight work, takes nothing new,
    and leaves the fleet when empty.

    ``run(trace)`` consumes ``paddle_tpu_torch.testing.load_gen`` trace
    entries
    (dicts with ``t``, ``prompt_len``, ``max_tokens``, optional
    ``deadline_s``, optional ``tenant``/``priority``) and reports SLO
    attainment, replica-seconds, scale events and flap count — the
    bench's attainment-vs-cost curve.

    With ``slo_evaluator`` (a :class:`~paddle_tpu_torch.observability.
    slo.SloEvaluator`), the sim also feeds a keyed
    :class:`~paddle_tpu_torch.observability.journey.TelemetryWindow` in
    virtual time — completions at their virtual finish, sheds at shed
    time — and steps the evaluator at every policy poll: the result
    grows an ``"slo"`` block (transitions + per-poll series), and the
    policy feed carries ``firing_alerts`` exactly like the live loop,
    so burn-rate alerting and alert-driven scaling are benchable
    deterministically.
    """

    def __init__(self, policy: Optional[ScalePolicy] = None, *,
                 min_replicas: int = 1, max_replicas: int = 4,
                 start_replicas: Optional[int] = None,
                 slots_per_replica: int = 4,
                 prefill_s: float = 0.05, token_s: float = 0.01,
                 build_s: float = 2.0, slo_ttft_s: Optional[float] = None,
                 tick_s: float = 0.02, policy_poll_s: float = 0.25,
                 window_s: float = 5.0, slo_evaluator=None,
                 warm_pool: int = 0, route_in_s: float = 0.05):
        self.policy = policy
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.start_replicas = (self.min_replicas if start_replicas is None
                               else int(start_replicas))
        self.slots = int(slots_per_replica)
        self.prefill_s = float(prefill_s)
        self.token_s = float(token_s)
        self.build_s = float(build_s)
        self.slo_ttft_s = float(
            slo_ttft_s if slo_ttft_s is not None else
            (policy.slo_ttft_s if policy is not None else 2.0))
        self.tick_s = float(tick_s)
        self.policy_poll_s = float(policy_poll_s)
        self.window_s = float(window_s)
        self.slo_evaluator = slo_evaluator
        # warm pool: `warm_pool` pre-built spares sit on
        # the shelf burning replica-seconds; an up decision consumes
        # one — the new replica matures in `route_in_s` instead of
        # `build_s` — and a refill build (build_s) restocks the shelf
        self.warm_pool = int(warm_pool)
        self.route_in_s = float(route_in_s)

    def _est_ttft(self, queue, fleet, now: float) -> float:
        # the shed formula over SERVICE time: a new arrival waits for
        # the queued + in-flight work ahead of it to drain through the
        # fleet's slots (each request holds a slot for prefill +
        # tokens*token_s — counting only token cost would blind the
        # estimate exactly when prefill dominates).  In-flight work
        # counts its RESIDUAL, not its full service.
        backlog_s = sum(r["service"] for r in queue)
        for rep in fleet:
            backlog_s += sum(max(0.0, a[0] - now) for a in rep.active)
        slots = sum(self.slots for rep in fleet if rep.state == "up") or 1
        return self.prefill_s + backlog_s / slots

    def run(self, trace) -> dict:
        import heapq
        trace = sorted(trace, key=lambda e: e["t"])
        n_arrivals = len(trace)
        fleet = [_SimReplica(f"sim{i}", "up", 0.0)
                 for i in range(self.start_replicas)]
        next_name = self.start_replicas
        queue: list = []                 # waiting requests
        done: list = []                  # {t, ttft, wait} completion log
        sheds: list = []                 # shed timestamps
        events: list = []                # scale events {t, direction, reason}
        ev = self.slo_evaluator
        tw = None
        pending_obs: list = []           # heap: completions by finish time
        obs_seq = 0                      # heap tiebreak (dicts don't order)
        slo_transitions: list = []
        slo_series: list = []
        slo_att_series: list = []
        if ev is not None:
            from ..observability.journey import TelemetryWindow
            tw = TelemetryWindow(window_s=max(
                o.slow_window_s for o in ev.objectives))
        t = 0.0
        i = 0                            # trace cursor
        next_poll = self.policy_poll_s
        replica_seconds = 0.0
        peak = len(fleet)
        spares = self.warm_pool          # parked spares, ready now
        refills: list = []               # refill builds, by finish time
        warm_route_ins = 0
        t_end_cap = (trace[-1]["t"] if trace else 0.0) + 300.0
        while t <= t_end_cap:
            # warm-pool refills mature
            while refills and refills[0] <= t:
                refills.pop(0)
                spares += 1
            # arrivals
            while i < len(trace) and trace[i]["t"] <= t:
                e = trace[i]
                i += 1
                service = self.prefill_s + e["max_tokens"] * self.token_s
                deadline = e.get("deadline_s")
                if deadline is not None and \
                        self._est_ttft(queue, fleet, t) > deadline:
                    sheds.append(t)
                    if tw is not None:
                        tw.observe_shed("slo_shed", now=t,
                                        tenant=e.get("tenant"),
                                        priority=e.get("priority"))
                    continue
                queue.append({"t_arr": e["t"], "service": service,
                              "tokens": int(e["max_tokens"]),
                              "tenant": e.get("tenant"),
                              "priority": e.get("priority")})
            # builds mature
            for rep in fleet:
                if rep.state == "building" and rep.ready_at <= t:
                    rep.state = "up"
            # completions
            for rep in fleet:
                if rep.active:
                    rep.active = [a for a in rep.active if a[0] > t]
            # drains finishing: empty draining replicas leave the fleet
            removed = [rep for rep in fleet
                       if rep.state == "draining" and not rep.active]
            if removed:
                fleet = [rep for rep in fleet if rep not in removed]
            # dispatch queue -> least-loaded up replica with a free slot
            while queue:
                ups = [rep for rep in fleet if rep.state == "up" and
                       len(rep.active) < self.slots]
                if not ups:
                    break
                rep = min(ups, key=lambda r: len(r.active))
                req = queue.pop(0)
                wait = t - req["t_arr"]
                ttft = wait + self.prefill_s
                finish = t + req["service"]
                rep.active.append((finish, ttft <= self.slo_ttft_s,
                                   req["service"]))
                done.append({"t": finish, "ttft": ttft, "wait": wait})
                if tw is not None:
                    # the window sees the completion at its virtual
                    # FINISH time, not at dispatch — burn rates must
                    # lag reality exactly like the live loop's do
                    obs_seq += 1
                    heapq.heappush(pending_obs, (finish, obs_seq, {
                        "ttft_s": ttft, "queue_wait_s": wait,
                        "wall_s": wait + req["service"],
                        "tenant": req["tenant"],
                        "priority": req["priority"]}))
            # policy poll (+ SLO evaluator tick at the same cadence)
            if (self.policy is not None or ev is not None) \
                    and t >= next_poll:
                next_poll += self.policy_poll_s
                firing = []
                if ev is not None:
                    while pending_obs and pending_obs[0][0] <= t:
                        finish, _, obs = heapq.heappop(pending_obs)
                        tw.observe_sample(now=finish, **obs)
                    slo_transitions.extend(ev.tick(tw, now=t))
                    firing = ev.firing()
                    slo_series.extend(
                        dict(row, t=round(t, 3)) for row in ev.state())
                    # attainment over the whole SLO period so far (the
                    # trace IS the compliance window) — the burn-rate
                    # alert's job is to lead THIS curve's breach
                    n_done = n_hit = 0
                    for d in done:
                        if d["t"] <= t:
                            n_done += 1
                            n_hit += d["ttft"] <= self.slo_ttft_s
                    slo_att_series.append({
                        "t": round(t, 3),
                        "attainment": round(n_hit / n_done, 4)
                        if n_done else None})
                if self.policy is not None:
                    feed = self._feed(t, queue, fleet, done, sheds)
                    feed["firing_alerts"] = firing
                    decision, reason = self.policy.decide(
                        feed,
                        replicas=sum(1 for r in fleet if r.state == "up"),
                        min_replicas=self.min_replicas,
                        max_replicas=self.max_replicas, now=t)
                    if decision == "up" and \
                            len(fleet) < self.max_replicas:
                        self.policy.note_event("up", t)
                        if spares > 0:
                            # route the parked spare in: reaction is a
                            # route-in, and a refill restocks the shelf
                            spares -= 1
                            warm_route_ins += 1
                            reaction = self.route_in_s
                            refills.append(t + self.build_s)
                            refills.sort()
                        else:
                            reaction = self.build_s
                        fleet.append(_SimReplica(
                            f"sim{next_name}", "building", t,
                            ready_at=t + reaction))
                        next_name += 1
                        events.append({"t": round(t, 3),
                                       "direction": "up",
                                       "reason": reason,
                                       "warm": reaction < self.build_s,
                                       "reaction_s": round(reaction, 4)})
                    elif decision == "down":
                        ups = [r for r in fleet if r.state == "up"]
                        if len(ups) > self.min_replicas:
                            self.policy.note_event("down", t)
                            victim = min(ups,
                                         key=lambda r: len(r.active))
                            victim.state = "draining"
                            events.append({"t": round(t, 3),
                                           "direction": "down",
                                           "reason": reason})
            # spares and in-flight refills burn replica-seconds too —
            # the warm pool's cost side of the bench's attainment curve
            replica_seconds += (len(fleet) + spares +
                                len(refills)) * self.tick_s
            peak = max(peak, len(fleet))
            if i >= len(trace) and not queue and \
                    all(not rep.active for rep in fleet) and \
                    not pending_obs and (ev is None or not ev.firing()):
                break
            t += self.tick_s
        # completions recorded at dispatch may nominally finish past the
        # loop's last tick; they are in `done` already (finish stamped)
        hits = sum(1 for d in done if d["ttft"] <= self.slo_ttft_s)
        ttfts = sorted(d["ttft"] for d in done)
        flaps = self._count_flaps(events)
        slo_block = None
        if ev is not None:
            slo_block = {
                "transitions": slo_transitions,
                "fired": sum(1 for tr in slo_transitions
                             if tr["to"] == "firing"),
                "resolved": sum(1 for tr in slo_transitions
                                if tr["to"] == "resolved"),
                "series": slo_series,
                "attainment_series": slo_att_series,
            }
        warm_block = None
        if self.warm_pool > 0:
            reactions = [e["reaction_s"] for e in events
                         if e.get("warm")]
            warm_block = {
                "pool": self.warm_pool,
                "route_in_s": self.route_in_s,
                "warm_route_ins": warm_route_ins,
                "max_warm_reaction_s": round(max(reactions), 4)
                if reactions else None,
            }
        return {
            "slo": slo_block,
            "warm": warm_block,
            "arrivals": n_arrivals,
            "completed": len(done),
            "shed": len(sheds),
            "slo_attainment": round(hits / n_arrivals, 4) if n_arrivals
            else 1.0,
            "replica_seconds": round(replica_seconds, 2),
            "peak_replicas": peak,
            "final_replicas": len(fleet),
            "events": events,
            "flaps": flaps,
            "duration_s": round(t, 2),
            "ttft_p50_s": round(_pct(ttfts, 0.50), 4) if ttfts else None,
            "ttft_p99_s": round(_pct(ttfts, 0.99), 4) if ttfts else None,
        }

    def _feed(self, t, queue, fleet, done, sheds) -> dict:
        lo = t - self.window_s
        recent = [d for d in done if lo < d["t"] <= t]
        recent_shed = [s for s in sheds if lo < s <= t]
        waits = sorted(d["wait"] for d in recent)
        ttfts = sorted(d["ttft"] for d in recent)
        n = len(recent)
        denom = n + len(recent_shed)
        return {
            "est_ttft_s": self._est_ttft(queue, fleet, t),
            "queue_wait_s": {"p50": _pct(waits, 0.5),
                             "p99": _pct(waits, 0.99), "n": n},
            "ttft_s": {"p50": _pct(ttfts, 0.5),
                       "p99": _pct(ttfts, 0.99), "n": n},
            "requests": n,
            "shed": len(recent_shed),
            "shed_rate": round(len(recent_shed) / denom, 4) if denom
            else 0.0,
            "queue_depth": len(queue),
            "slots_in_use": sum(len(r.active) for r in fleet),
            "total_slots": sum(self.slots for r in fleet
                               if r.state == "up") or 1,
        }

    def _count_flaps(self, events) -> int:
        """up→down (or down→up) direction changes inside one cooldown
        window — the thing hysteresis + per-direction cooldowns exist
        to prevent; the bench gates this at zero."""
        if self.policy is None:
            return 0
        window = min(self.policy.cooldown_up_s,
                     self.policy.cooldown_down_s)
        flaps = 0
        for a, b in zip(events, events[1:]):
            if a["direction"] != b["direction"] and \
                    b["t"] - a["t"] < window:
                flaps += 1
        return flaps


def _pct(vals, q: float) -> float:
    if not vals:
        return 0.0
    if len(vals) == 1:
        return float(vals[0])
    pos = q * (len(vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    frac = pos - lo
    return float(vals[lo] * (1 - frac) + vals[hi] * frac)
