"""Rolling fleet upgrades — canary-gated zero-downtime revision rollout.

The port's copy of ``paddle_tpu/serving/rollout.py``: replace every
replica of a live fleet with builds from a NEW engine-factory revision
without dropping a request.  The :class:`RolloutController` runs the
upgrade from its own worker thread, reusing the autoscaler's scale-down
drain invariant: a replica leaves the fleet only after ``drain()`` →
wait-empty → ``remove_replica`` → teardown, never a kill.

The state machine::

    build canary at target revision ──► route in (router tags it with
        the revision label; /debug/fleet and
        paddle_tpu_fleet_replicas_alive{revision=...} show both
        revisions mid-upgrade)
    canary gate ──► the gateway's reaper feeds per-engine outcomes
        (note_outcome); the gate judges the canary's windowed error
        rate and TTFT p99 AGAINST THE INCUMBENTS' same-window numbers,
        plus its decode-signature count (``compile_stats()
        ["decode_compiles"]``: one captured decode graph a build; a
        revision that captures more fails before it hurts p99
        fleet-wide), after a
        minimum request count — a quiet canary passes at the gate
        timeout instead of wedging the upgrade
    PASS ──► replica-by-replica: retire the least-loaded incumbent
        (drain → wait-empty → remove → teardown), then for each
        remaining incumbent build a surge replica at the target
        revision first, so serving capacity never dips below the
        starting fleet size
    FAIL ──► automatic rollback: the canary (the only target-revision
        replica — no incumbent is touched before the gate) is drained
        out and torn down; the result is a typed
        :class:`RolloutRolledBack` naming the failed gate

Crash containment mirrors the autoscaler's: the three seams —
``rollout.build``, ``rollout.canary_gate``, ``rollout.drain_old`` —
absorb injected faults.  A canary build that keeps failing rolls the
upgrade back (nothing was removed yet, so "all-old" is trivially
restored); a POST-gate build or drain failure is retried forever — the
gate already proved the revision good, and rolling back after
incumbents left would be the real availability risk.  Steady state is
never mixed: all-new on success, all-old after rollback.

Coordination: the gateway counts an in-flight rollout build as
capacity-on-the-way (no all-dead 503 mid-upgrade) and caps shed
Retry-After at :meth:`RolloutController.expected_ready_s` (the same
cold-build EWMA trick the autoscaler uses); the autoscaler never picks
a target-revision replica as a scale-down victim (``protected()``) and
builds scale-ups at the ROLLOUT's revision while one is active
(``revision()``/``factory()``), so a flash crowd mid-upgrade grows the
new fleet instead of resurrecting the old one.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

from ..observability import flight, registry
from ..testing import faults
from .autoscaler import _pct

__all__ = ["RolloutError", "RolloutResult", "RolloutRolledBack",
           "CanaryGate", "RolloutController", "FLEET_ROLLOUTS"]

FLEET_ROLLOUTS = "paddle_tpu_fleet_rollouts_total"


class RolloutError(RuntimeError):
    """Rollout misuse: one already in flight, or a no-op target."""


class RolloutResult:
    """Outcome of a completed rollout: the fleet serves ``revision``."""

    ok = True

    def __init__(self, revision: str, upgraded: int, gate: str = "passed",
                 detail: str = ""):
        self.revision = str(revision)
        self.upgraded = int(upgraded)     # replicas built at the target
        self.gate = str(gate)             # gate that decided the outcome
        self.detail = str(detail)

    def __repr__(self):
        return (f"{type(self).__name__}(revision={self.revision!r}, "
                f"upgraded={self.upgraded}, gate={self.gate!r}, "
                f"detail={self.detail!r})")


class RolloutRolledBack(RolloutResult):
    """The canary gate (or its build) failed: every target-revision
    replica was drained out and torn down, the incumbents were never
    touched — the fleet serves exactly what it served before.  ``gate``
    names the check that bit (``error_rate`` / ``ttft_p99`` /
    ``decode_signatures`` / ``build`` / ``crash``)."""

    ok = False


class CanaryGate:
    """Pure judgment over the canary's observed window vs the
    incumbents' — no state, so the rollout worker can re-judge after an
    injected crash without skew, and unit tests feed it synthetic
    windows directly.

    Checks, in order:

    * ``decode_signatures`` — the canary captured more decode graphs
      than ``max_decode_signatures`` (default 1: one captured decode
      graph a build; a revision that re-specialises per batch shape
      fails here long before p99 shows it).
    * ``error_rate`` — canary windowed error rate exceeds the
      incumbents' by more than ``err_rate_slack``.
    * ``ttft_p99`` — canary TTFT p99 exceeds the incumbents' p99 by
      ``ttft_p99_ratio``× AND the absolute ``ttft_p99_floor_s`` (the
      floor keeps a 2ms-vs-1ms blip from failing an upgrade).

    Judgment waits for ``min_requests`` canary outcomes; a canary still
    quieter than that at ``timeout_s`` PASSES (gate ``"quiet"``) — an
    idle fleet must stay upgradeable.
    """

    def __init__(self, *, min_requests: int = 8, timeout_s: float = 60.0,
                 err_rate_slack: float = 0.10, ttft_p99_ratio: float = 2.0,
                 ttft_p99_floor_s: float = 0.05,
                 max_decode_signatures: int = 1):
        if min_requests < 1:
            raise ValueError("min_requests must be >= 1")
        self.min_requests = int(min_requests)
        self.timeout_s = float(timeout_s)
        self.err_rate_slack = float(err_rate_slack)
        self.ttft_p99_ratio = float(ttft_p99_ratio)
        self.ttft_p99_floor_s = float(ttft_p99_floor_s)
        self.max_decode_signatures = int(max_decode_signatures)

    def judge(self, canary: dict, incumbent: dict, decode_signatures: int,
              waited_s: float) -> Optional[tuple]:
        """(ok, gate, detail), or None for "keep watching".  ``canary``
        and ``incumbent`` are ``{"n", "errors", "ttft": [seconds]}``
        windows observed over the SAME wall interval."""
        if decode_signatures > self.max_decode_signatures:
            return (False, "decode_signatures",
                    f"canary compiled {decode_signatures} decode "
                    f"signatures (max {self.max_decode_signatures})")
        n = int(canary.get("n", 0))
        if n < self.min_requests:
            if waited_s >= self.timeout_s:
                return (True, "quiet",
                        f"only {n}/{self.min_requests} canary requests "
                        f"in {waited_s:.1f}s; passing a quiet canary")
            return None
        err_rate = canary.get("errors", 0) / n
        inc_n = int(incumbent.get("n", 0))
        inc_rate = (incumbent.get("errors", 0) / inc_n) if inc_n else 0.0
        if err_rate > inc_rate + self.err_rate_slack:
            return (False, "error_rate",
                    f"canary error rate {err_rate:.3f} vs incumbent "
                    f"{inc_rate:.3f} (+{self.err_rate_slack} slack)")
        c_ttft = sorted(canary.get("ttft") or [])
        i_ttft = sorted(incumbent.get("ttft") or [])
        if c_ttft and i_ttft:
            c_p99 = _pct(c_ttft, 0.99)
            i_p99 = _pct(i_ttft, 0.99)
            if c_p99 > i_p99 * self.ttft_p99_ratio and \
                    c_p99 > self.ttft_p99_floor_s:
                return (False, "ttft_p99",
                        f"canary TTFT p99 {c_p99 * 1e3:.1f}ms vs "
                        f"incumbent {i_p99 * 1e3:.1f}ms "
                        f"(x{self.ttft_p99_ratio} allowed)")
        return (True, "passed",
                f"{n} canary requests, error rate {err_rate:.3f}")

    def snapshot(self) -> dict:
        return {"min_requests": self.min_requests,
                "timeout_s": self.timeout_s,
                "err_rate_slack": self.err_rate_slack,
                "ttft_p99_ratio": self.ttft_p99_ratio,
                "ttft_p99_floor_s": self.ttft_p99_floor_s,
                "max_decode_signatures": self.max_decode_signatures}


class RolloutController:
    """Zero-downtime revision rollout over a gateway's fleet.

    Args:
        stack: the :class:`~paddle_tpu_torch.serving.gateway.Gateway` (or a
            ``GatewayStack`` — its ``.gateway`` is used) whose router
            membership the rollout rewrites.
        factory_for_revision: ``revision -> Engine-shaped replica``
            (an ``Engine`` or ``EngineSupervisor``).  Called from the
            rollout worker; a raise fails that build (retried, or —
            pre-gate — rolled back).  Each build captures its own decode
            graph on its own stream, exactly like the autoscaler's.
        gate: a :class:`CanaryGate` (default one is built).
        drain_deadline_s: per-attempt deadline for retiring drains.
        build_s_hint: seeds the cold-build EWMA behind
            :meth:`expected_ready_s` before the first in-loop build.
        max_step_retries: how many times a PRE-gate (canary) build is
            retried before the rollout rolls back; post-gate steps
            retry until shutdown.
        name_prefix: new replicas are ``{prefix}-{revision}-u{N}``
            with a monotone N (metric series never collide).
    """

    def __init__(self, stack, factory_for_revision: Callable[[str], object],
                 *, gate: Optional[CanaryGate] = None,
                 drain_deadline_s: float = 30.0,
                 build_s_hint: float = 10.0, max_step_retries: int = 3,
                 gate_poll_s: float = 0.05, name_prefix: str = "engine"):
        gateway = getattr(stack, "gateway", stack)
        self.gateway = gateway
        self.factory_for_revision = factory_for_revision
        self.gate = gate or CanaryGate()
        self.drain_deadline_s = float(drain_deadline_s)
        self.max_step_retries = int(max_step_retries)
        self.gate_poll_s = float(gate_poll_s)
        self.name_prefix = str(name_prefix)
        self._lock = threading.Lock()
        self._stop_ev = threading.Event()
        self._done_ev = threading.Event()
        self._done_ev.set()               # nothing in flight yet
        revs = gateway.router.revisions()
        self._revision = next(iter(revs.values()), "r0")
        self._target: Optional[str] = None
        self._op: Optional[dict] = None   # {"step","replica","t0"}
        self._build_ewma_s = float(build_s_hint)
        self._builds = 0
        self._replica_n = 0
        self._events: deque = deque(maxlen=128)
        self._obs: dict = {}              # engine -> outcome window
        self._result: Optional[RolloutResult] = None
        self._thread: Optional[threading.Thread] = None
        gateway.attach_rollout(self)

    # -- operator surface ----------------------------------------------------
    def rollout(self, revision: str, wait: bool = True,
                timeout: Optional[float] = None):
        """Upgrade the fleet to ``revision``.  With ``wait`` (default)
        blocks and returns the typed result — a :class:`RolloutResult`
        on success, :class:`RolloutRolledBack` when the canary gate
        bit; otherwise returns None immediately (poll :meth:`wait`)."""
        self.start_rollout(revision)
        return self.wait(timeout) if wait else None

    def start_rollout(self, revision: str):
        revision = str(revision)
        if self._stop_ev.is_set():
            raise RolloutError("rollout controller is shut down")
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                raise RolloutError(
                    f"a rollout to {self._target!r} is already in flight")
            if revision == self._revision:
                raise RolloutError(
                    f"fleet is already at revision {revision!r}")
            self._target = revision
            self._result = None
            self._obs = {}
            self._op = {"step": "start", "replica": "",
                        "t0": time.monotonic()}
            self._done_ev.clear()
            self._thread = threading.Thread(
                target=self._run, args=(revision,),
                name="paddle-tpu-rollout", daemon=True)
            self._thread.start()

    def wait(self, timeout: Optional[float] = None) -> RolloutResult:
        if not self._done_ev.wait(timeout):
            raise TimeoutError("rollout still in flight")
        with self._lock:
            return self._result

    def note_outcome(self, engine: str, ok: bool,
                     ttft_s: Optional[float] = None):
        """One reaped request outcome, attributed to its replica — the
        gateway's reaper is the only caller (outcomes carry an engine
        name only there).  Ignored while no rollout is active."""
        with self._lock:
            if self._target is None:
                return
            o = self._obs.get(engine)
            if o is None:
                o = self._obs[engine] = {"n": 0, "errors": 0,
                                         "ttft": deque(maxlen=256)}
            o["n"] += 1
            if not ok:
                o["errors"] += 1
            if ttft_s is not None:
                o["ttft"].append(float(ttft_s))

    def revision(self) -> str:
        """The revision new replicas should be built at RIGHT NOW: the
        rollout target while one is active, else the fleet's current
        revision — the autoscaler's scale-up input, so a flash crowd
        mid-upgrade grows the NEW fleet."""
        with self._lock:
            return self._target or self._revision

    def factory(self) -> Callable[[], object]:
        """Zero-arg factory building at :meth:`revision` (the
        autoscaler swaps this in for its own while a rollout runs)."""
        rev = self.revision()
        return lambda: self.factory_for_revision(rev)

    def protected(self) -> frozenset:
        """Replica names scale-down must not victimise: every
        target-revision replica while a rollout is active (draining a
        just-built canary would unwind the upgrade)."""
        with self._lock:
            target = self._target
        if target is None:
            return frozenset()
        return frozenset(n for n, r in
                         self.gateway.router.revisions().items()
                         if r == target)

    def active(self) -> bool:
        with self._lock:
            return self._target is not None

    def build_pending(self) -> bool:
        """True while the worker is mid-build of a replacement replica
        — the gateway treats this as capacity-on-the-way."""
        with self._lock:
            return self._op is not None and self._op.get("step") == "build"

    def expected_ready_s(self) -> Optional[float]:
        """Seconds until the in-flight rollout build takes traffic
        (cold-build EWMA minus elapsed); None when no build is in
        flight.  Caps shed Retry-After exactly like the autoscaler's."""
        with self._lock:
            if self._op is not None and self._op.get("step") == "build":
                elapsed = time.monotonic() - self._op["t0"]
                return max(0.1, self._build_ewma_s - elapsed)
        return None

    def stats(self) -> dict:
        """The ``/debug/fleet`` rollout block: current/target revision,
        the in-flight step, cold-build EWMA, canary windows, recent
        events and the last result."""
        with self._lock:
            op = dict(self._op) if self._op is not None else None
            res = self._result
            out = {
                "revision": self._revision,
                "target": self._target,
                "build_ewma_s": round(self._build_ewma_s, 3),
                "builds": self._builds,
                "events": list(self._events),
                "canary": {name: {"n": o["n"], "errors": o["errors"]}
                           for name, o in self._obs.items()},
                "result": None if res is None else {
                    "ok": res.ok, "revision": res.revision,
                    "upgraded": res.upgraded, "gate": res.gate,
                    "detail": res.detail},
            }
        if op is not None:
            op["elapsed_s"] = round(time.monotonic() - op.pop("t0"), 3)
        out["op"] = op
        out["gate"] = self.gate.snapshot()
        return out

    def shutdown(self):
        """Stop the worker (replicas stay as they are — a rollout
        interrupted by process shutdown reports ``gate="shutdown"``)."""
        self._stop_ev.set()
        with self._lock:
            th = self._thread
        if th is not None:
            th.join(timeout=10)

    close = shutdown

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- rollout worker ------------------------------------------------------
    def _run(self, target: str):
        result = None
        try:
            result = self._upgrade(target)
        except Exception as e:  # noqa: BLE001 — an unexpected crash must
            # still leave a typed result and (pre-gate) a uniform fleet
            flight.record("rollout", "crashed", revision=target,
                          error=f"{type(e).__name__}: {e}")
            try:
                result = self._rollback(target, "crash",
                                        f"{type(e).__name__}: {e}")
            except Exception as e2:  # noqa: BLE001 — last resort
                result = RolloutRolledBack(target, 0, "crash",
                                           f"{type(e2).__name__}: {e2}")
        finally:
            ok = result is not None and result.ok
            with self._lock:
                if ok:
                    self._revision = target
                self._result = result
                self._target = None
                self._op = None
                self._obs = {}
            outcome = "upgraded" if ok else "rolled_back"
            registry().counter(
                FLEET_ROLLOUTS, "fleet rollouts by outcome").inc(
                1.0, labels={"outcome": outcome, "revision": target})
            flight.record("rollout", "done", revision=target,
                          outcome=outcome,
                          gate=result.gate if result is not None else "")
            self._done_ev.set()

    def _upgrade(self, target: str) -> RolloutResult:
        flight.record("rollout", "begin", revision=target)
        self._event("begin", revision=target)
        canary = self._build_replica(target, role="canary",
                                     retry_forever=False)
        if canary is None:
            return self._rollback(
                target, "build", f"canary build still failing after "
                f"{self.max_step_retries} retries")
        ok, gate_name, detail = self._canary_gate(canary)
        if not ok:
            return self._rollback(target, gate_name, detail)
        self._event("canary_passed", gate=gate_name)
        flight.record("rollout", "canary_passed", replica=canary[0],
                      gate=gate_name, detail=detail)
        # the canary IS the first incumbent's replacement: retire one
        # old replica without a surge build, then surge-build before
        # every further retirement — capacity never dips below the
        # starting fleet size
        upgraded = 1
        first = self._next_incumbent(target)
        if first is not None:
            self._retire_old(*first)
        while not self._stop_ev.is_set():
            victim = self._next_incumbent(target)
            if victim is None:
                break
            built = self._build_replica(target, role="surge",
                                        retry_forever=True)
            if built is None:
                break                    # shut down mid-build
            upgraded += 1
            self._retire_old(*victim)
        if self._next_incumbent(target) is not None:
            return RolloutRolledBack(
                target, upgraded, "shutdown",
                "shut down mid-rollout; fleet left mixed")
        # the warm pool upgrades too: a parked spare at the OLD revision
        # must never route in after the fleet moved on
        a = getattr(self.gateway, "autoscaler", None)
        if a is not None and hasattr(a, "drop_warm_pool"):
            a.drop_warm_pool(keep_revision=target, reason="rollout")
        return RolloutResult(target, upgraded, "passed",
                             f"fleet at revision {target!r}")

    def _build_replica(self, target: str, role: str,
                       retry_forever: bool) -> Optional[tuple]:
        """Build + route in one replica at ``target``; (name, engine)
        or None when retries ran out (pre-gate) / shutdown."""
        attempts = 0
        while not self._stop_ev.is_set():
            attempts += 1
            with self._lock:
                self._replica_n += 1
                name = f"{self.name_prefix}-{target}-u{self._replica_n}"
                self._op = {"step": "build", "replica": name,
                            "t0": time.monotonic()}
            flight.record("rollout", "build_begin", replica=name,
                          revision=target, role=role, attempt=attempts)
            t0 = time.monotonic()
            eng = None
            try:
                faults.fault_point("rollout.build", replica=name,
                                   revision=target)
                eng = self.factory_for_revision(target)
                self.gateway.router.add_replica(name, eng,
                                                revision=target)
            except Exception as e:  # noqa: BLE001 — a failed build is
                # ABSORBED: the fleet still serves on the incumbents
                if eng is not None:
                    try:
                        eng.shutdown()
                    except Exception:  # noqa: BLE001 — never routed
                        pass
                flight.record("rollout", "build_failed", replica=name,
                              attempt=attempts,
                              error=f"{type(e).__name__}: {e}")
                self._event("build_failed", replica=name)
                if not retry_forever and attempts > self.max_step_retries:
                    with self._lock:
                        self._op = None
                    return None
                self._stop_ev.wait(min(0.05 * attempts, 0.5))
                continue
            self._await_warm(eng)
            build_s = time.monotonic() - t0
            with self._lock:
                self._builds += 1
                a = 0.5 if self._builds > 1 else 1.0
                self._build_ewma_s = \
                    (1 - a) * self._build_ewma_s + a * build_s
                self._op = None
            self._event("routed_in", replica=name, role=role)
            flight.record("rollout", "routed_in", replica=name,
                          revision=target, role=role,
                          build_ms=round(build_s * 1e3, 1))
            return (name, eng)
        with self._lock:
            self._op = None
        return None

    def _await_warm(self, engine, timeout_s: float = 120.0):
        """Hold the build step open until the replica is WARM (decode
        graph captured) — mirrors the autoscaler: warm-up completion is what
        the EWMA must measure.  Early-exits on an idle fleet or an
        engine without a health surface (router stubs in tests)."""
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
                return
            time.sleep(0.05)

    def _canary_gate(self, canary: tuple) -> tuple:
        """Watch the canary until the gate decides.  A crash inside the
        judgment loop (the ``rollout.canary_gate`` seam) is absorbed
        and the gate re-judged — never skipped."""
        name, eng = canary
        t0 = time.monotonic()
        with self._lock:
            self._op = {"step": "canary_gate", "replica": name, "t0": t0}
            self._obs = {}               # judge from a clean window
        flight.record("rollout", "canary_gate_begin", replica=name)
        while not self._stop_ev.is_set():
            waited = time.monotonic() - t0
            try:
                faults.fault_point("rollout.canary_gate", replica=name)
                with self._lock:
                    src = self._obs.get(name)
                    can = ({"n": src["n"], "errors": src["errors"],
                            "ttft": list(src["ttft"])} if src else
                           {"n": 0, "errors": 0, "ttft": []})
                    inc = {"n": 0, "errors": 0, "ttft": []}
                    for other, o in self._obs.items():
                        if other == name:
                            continue
                        inc["n"] += o["n"]
                        inc["errors"] += o["errors"]
                        inc["ttft"].extend(o["ttft"])
                verdict = self.gate.judge(can, inc,
                                          self._decode_signatures(eng),
                                          waited)
            except Exception as e:  # noqa: BLE001 — re-judge, never skip
                flight.record("rollout", "canary_gate_retry",
                              replica=name,
                              error=f"{type(e).__name__}: {e}")
                self._stop_ev.wait(self.gate_poll_s)
                continue
            if verdict is not None:
                with self._lock:
                    self._op = None
                flight.record("rollout", "canary_verdict", replica=name,
                              ok=bool(verdict[0]), gate=verdict[1],
                              detail=verdict[2])
                return verdict
            self._stop_ev.wait(self.gate_poll_s)
        with self._lock:
            self._op = None
        return (False, "shutdown", "shut down mid-gate")

    @staticmethod
    def _decode_signatures(eng) -> int:
        """Decode graphs this build captured (0 when the engine has no
        compile surface — router stubs).  A real engine's error is not
        swallowed: it reaches the gate loop, which records it and
        re-judges."""
        cs = getattr(eng, "compile_stats", None)
        if cs is None:
            return 0
        return int(cs()["decode_compiles"])

    def _next_incumbent(self, target: str) -> Optional[tuple]:
        """(name, engine) of the least-loaded replica NOT at the target
        revision; None once the fleet is uniform."""
        router = self.gateway.router
        revs = router.revisions()
        old = [n for n, r in revs.items() if r != target]
        if not old:
            return None
        loads = router.loads()
        name = min(old, key=lambda n: (
            loads.get(n, {}).get("slots_in_use", 0) +
            loads.get(n, {}).get("queue_depth", 0), n))
        eng = dict(zip(router.names, router.engines)).get(name)
        return (name, eng) if eng is not None else None

    def _retire_old(self, name: str, eng) -> bool:
        """Drain → wait-empty → remove → teardown, the scale-down
        invariant verbatim: retirement NEVER kills in-flight work.  A
        replica that dies mid-drain is healed by its supervisor and the
        drain re-issued; the ``rollout.drain_old`` seam crashes are
        absorbed the same way."""
        flight.record("rollout", "drain_old_begin", replica=name)
        with self._lock:
            self._op = {"step": "drain_old", "replica": name,
                        "t0": time.monotonic()}
        t0 = time.monotonic()
        drained = False
        attempts = 0
        while not self._stop_ev.is_set():
            attempts += 1
            try:
                faults.fault_point("rollout.drain_old", replica=name)
                drained = eng.drain(self.drain_deadline_s)
            except Exception as e:  # noqa: BLE001 — absorb + retry
                flight.record("rollout", "drain_old_retry", replica=name,
                              attempt=attempts,
                              error=f"{type(e).__name__}: {e}")
                self._stop_ev.wait(min(0.05 * attempts, 0.5))
                continue
            if drained:
                break
            flight.record("rollout", "drain_retry", replica=name,
                          attempt=attempts)
        if not drained:
            with self._lock:
                self._op = None
            return False                 # shut down mid-drain: leave it
        try:
            self.gateway.router.remove_replica(name)
        except (KeyError, ValueError) as e:
            # raced a concurrent removal (autoscaler scale-down picked
            # the same victim): the drain already emptied it
            flight.record("rollout", "remove_raced", replica=name,
                          error=f"{type(e).__name__}: {e}")
        try:
            eng.shutdown()               # teardown releases ledger rows
        except Exception:  # noqa: BLE001 — the replica is already empty
            pass
        with self._lock:
            self._op = None
        self._event("retired", replica=name)
        flight.record("rollout", "retired", replica=name,
                      drain_attempts=attempts,
                      drain_ms=round((time.monotonic() - t0) * 1e3, 1))
        return True

    def _rollback(self, target: str, gate: str,
                  detail: str) -> RolloutRolledBack:
        """Undo a failed canary: drain out and tear down every
        target-revision replica (before the gate passes that is only
        the canary — incumbents are never touched), leaving the fleet
        exactly as it was."""
        flight.record("rollout", "rollback_begin", revision=target,
                      gate=gate, detail=str(detail)[:200])
        self._event("rollback", gate=gate)
        router = self.gateway.router
        removed = 0
        for name, rev in sorted(router.revisions().items()):
            if rev != target:
                continue
            eng = dict(zip(router.names, router.engines)).get(name)
            if eng is None:
                continue
            if self._retire_old(name, eng):
                removed += 1
        flight.record("rollout", "rolled_back", revision=target,
                      gate=gate, removed=removed)
        return RolloutRolledBack(target, 0, gate, detail)

    def _event(self, what: str, **kw):
        with self._lock:
            self._events.append(dict({"t": time.time(), "event": what},
                                     **kw))
