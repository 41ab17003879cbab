"""SLO engine — declarative objectives, burn-rate alerts, incidents.

The port's copy of ``paddle_tpu/observability/slo.py``: the same
objectives, transitions, gauge names, flight events and incident schema.
Journeys partition host wall time and perfscope device time and memory;
this module judges them, in three layers:

* :class:`SloObjective` — a declarative statement of "good": a signal
  (``ttft_p99`` / ``queue_wait_p99`` / ``token_p99`` / ``shed_rate`` /
  ``availability``), a target fraction of good events, an optional
  latency threshold, and a selector (one tenant, one priority class, or
  ``per="tenant"|"class"`` to expand over every key the window has
  seen).
* :class:`SloEvaluator` — a PURE feed→decision object (the
  ``ScalePolicy`` shape): each :meth:`SloEvaluator.tick` reads raw
  events from a keyed :class:`~paddle_tpu_torch.observability.
  journey.TelemetryWindow` and steps a multi-window burn-rate state machine,
  Google-SRE style — the **fast** window catches flash crowds in
  seconds, the **slow** window catches slow leaks without flapping.
  Burn rate is ``error_rate / (1 - target)``: burn 1.0 spends the error
  budget exactly at the sustainable rate; the fast rule fires at a high
  multiple, the slow rule at a low one.  Alerts hold down through a
  pending → firing → resolved lifecycle (breach/clear tick streaks,
  exactly the autoscaler's up_ticks/idle_ticks hysteresis), so unit
  tests and ``FleetSim`` drive the whole machine in virtual time.
* :class:`SloEngine` — the live wrapper: a daemon thread polls the
  gateway window at ``tick_s``, exports attainment / budget / burn
  gauges, records ``"alert"`` flight events, and on each transition to
  firing writes a bounded on-disk **incident bundle**
  (:func:`build_incident` via :class:`IncidentStore`) correlating all
  three telemetry planes — keyed window snapshots, the slowest journey
  timelines in-window, the perfscope roofline + device memory ledger,
  ``fleet_stats()`` and the flight tail — one JSON per incident,
  ring-bounded, served by ``GET /debug/incidents[/<id>]`` and rendered
  by ``tools/incident_report.py``.

The firing set feeds back into the autoscaler as the optional
``firing_alerts`` policy-input field.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import deque

from . import flight, journey as journey_mod, registry, watchdog

__all__ = [
    "SloObjective", "SloEvaluator", "SloEngine", "IncidentStore",
    "build_incident", "SIGNALS", "INCIDENT_SCHEMA",
]

SIGNALS = ("ttft_p99", "queue_wait_p99", "token_p99", "shed_rate",
           "availability")
# latency-style signals judge each sample against threshold_s; the
# other two judge shed/outcome events directly
_LATENCY_FIELD = {"ttft_p99": "ttft_s", "queue_wait_p99": "queue_wait_s",
                  "token_p99": "token_s"}

INCIDENT_SCHEMA = "paddle_tpu.incident.v1"

SLO_ATTAINMENT = "paddle_tpu_slo_attainment"
SLO_BUDGET_REMAINING = "paddle_tpu_slo_error_budget_remaining"
SLO_BURN_RATE = "paddle_tpu_slo_burn_rate"
SLO_ALERTS = "paddle_tpu_slo_alerts_total"


class SloObjective:
    """One declarative objective: ``target`` fraction of events must be
    good over the slow window, where "good" is signal-specific (latency
    under ``threshold_s``, not shed, or outcome ok)."""

    def __init__(self, name: str, signal: str, target: float, *,
                 threshold_s: float | None = None,
                 tenant: str | None = None, priority: str | None = None,
                 per: str | None = None,
                 fast_window_s: float = 10.0, fast_burn: float = 10.0,
                 slow_window_s: float = 60.0, slow_burn: float = 2.0,
                 fire_ticks: int = 2, resolve_ticks: int = 3,
                 min_events: int = 4):
        if not name:
            raise ValueError("objective needs a name")
        if signal not in SIGNALS:
            raise ValueError(f"signal must be one of {SIGNALS}, "
                             f"got {signal!r}")
        if not 0.0 < target < 1.0:
            raise ValueError("target must be in (0, 1) — an SLO of 1.0 "
                             "has zero error budget and can never burn "
                             "at a finite rate")
        if signal in _LATENCY_FIELD:
            if threshold_s is None or threshold_s <= 0:
                raise ValueError(f"{signal} needs threshold_s > 0")
        if per not in (None, "tenant", "class"):
            raise ValueError('per must be None, "tenant" or "class"')
        if per is not None and (tenant is not None or priority is not None):
            raise ValueError("per= expands over every key; it is "
                             "mutually exclusive with a fixed tenant/"
                             "priority selector")
        if not 0 < fast_window_s < slow_window_s:
            raise ValueError("need 0 < fast_window_s < slow_window_s")
        if fast_burn <= 0 or slow_burn <= 0:
            raise ValueError("burn thresholds must be > 0")
        self.name = str(name)
        self.signal = str(signal)
        self.target = float(target)
        self.threshold_s = None if threshold_s is None else float(threshold_s)
        self.tenant = None if tenant is None else str(tenant)
        self.priority = None if priority is None else str(priority)
        self.per = per
        self.fast_window_s = float(fast_window_s)
        self.fast_burn = float(fast_burn)
        self.slow_window_s = float(slow_window_s)
        self.slow_burn = float(slow_burn)
        self.fire_ticks = max(1, int(fire_ticks))
        self.resolve_ticks = max(1, int(resolve_ticks))
        self.min_events = max(1, int(min_events))

    def snapshot(self) -> dict:
        return {
            "name": self.name, "signal": self.signal,
            "target": self.target, "threshold_s": self.threshold_s,
            "tenant": self.tenant, "priority": self.priority,
            "per": self.per,
            "fast_window_s": self.fast_window_s,
            "fast_burn": self.fast_burn,
            "slow_window_s": self.slow_window_s,
            "slow_burn": self.slow_burn,
            "fire_ticks": self.fire_ticks,
            "resolve_ticks": self.resolve_ticks,
            "min_events": self.min_events,
        }

    def counts(self, samples: list, sheds: list) -> tuple[int, int]:
        """``(good, bad)`` event counts for this objective's signal."""
        if self.signal == "shed_rate":
            return len(samples), len(sheds)
        if self.signal == "availability":
            good = sum(1 for s in samples if s.get("outcome") == "ok")
            return good, (len(samples) - good) + len(sheds)
        field = _LATENCY_FIELD[self.signal]
        vals = [s[field] for s in samples if s.get(field) is not None]
        bad = sum(1 for v in vals if v > self.threshold_s)
        return len(vals) - bad, bad


class _AlertState:
    """Per-(objective, key) hysteresis state.  Pure data — mutated only
    by the evaluator under its lock."""

    __slots__ = ("state", "breach_streak", "clear_streak", "rule", "since",
                 "burn_fast", "burn_slow", "attainment", "events")

    def __init__(self):
        self.state = "inactive"     # inactive | pending | firing
        self.breach_streak = 0
        self.clear_streak = 0
        self.rule = ""              # "fast" | "slow" once breaching
        self.since = None           # t of the pending/firing transition
        self.burn_fast = 0.0
        self.burn_slow = 0.0
        self.attainment = 1.0
        self.events = 0


class SloEvaluator:
    """Pure feed→decision burn-rate engine over a keyed TelemetryWindow.

    Call :meth:`tick` at a fixed cadence with an explicit ``now`` (or
    wall clock when live); it returns the alert *transitions* that
    happened this tick — ``pending`` / ``firing`` / ``resolved`` dicts
    — while :meth:`firing` and :meth:`state` expose the standing state.
    No threads, no I/O: FleetSim and unit tests drive it in virtual
    time, and :class:`SloEngine` wraps it for the live gateway.
    """

    def __init__(self, objectives):
        objectives = list(objectives)
        if not objectives:
            raise ValueError("need at least one SloObjective")
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        self.objectives = objectives
        self._lock = threading.Lock()
        self._alerts: dict[tuple[str, str], _AlertState] = {}

    # -- key expansion -------------------------------------------------------
    def _keys_for(self, obj: SloObjective, window, now: float) -> list:
        """(display_key, tenant_filter, priority_filter) triples this
        objective evaluates this tick.  ``per=`` objectives expand over
        the window's live keys UNION already-tracked alert keys, so an
        alert on a tenant that stopped sending traffic still ages out
        through resolve rather than sticking in firing forever."""
        if obj.per is None:
            key = obj.tenant if obj.tenant is not None else obj.priority
            return [(key if key is not None else "all",
                     obj.tenant, obj.priority)]
        idx = 0 if obj.per == "tenant" else 1
        seen = {k[idx] for k in window.keys(now=now)}
        with self._lock:
            seen |= {key for (name, key) in self._alerts
                     if name == obj.name}
        if obj.per == "tenant":
            return [(k, k, None) for k in sorted(seen)]
        return [(k, None, k) for k in sorted(seen)]

    @staticmethod
    def _burn(obj: SloObjective, window, now: float, horizon_s: float,
              tenant, priority) -> tuple[float, float, int]:
        """(error_rate, burn, total_events) over the trailing horizon."""
        samples, sheds = window.events(
            now=now, horizon_s=horizon_s, tenant=tenant, priority=priority)
        good, bad = obj.counts(samples, sheds)
        total = good + bad
        error_rate = (bad / total) if total else 0.0
        return error_rate, error_rate / (1.0 - obj.target), total

    # -- the state machine ---------------------------------------------------
    def tick(self, window, now: float | None = None) -> list:
        """Evaluate every objective against the window; returns the
        transitions that happened this tick."""
        now = time.perf_counter() if now is None else float(now)
        transitions = []
        for obj in self.objectives:
            for key, tenant, priority in self._keys_for(obj, window, now):
                tr = self._tick_one(obj, key, tenant, priority, window, now)
                if tr is not None:
                    transitions.append(tr)
        return transitions

    def _tick_one(self, obj, key, tenant, priority, window, now):
        err_fast, burn_fast, n_fast = self._burn(
            obj, window, now, obj.fast_window_s, tenant, priority)
        err_slow, burn_slow, n_slow = self._burn(
            obj, window, now, obj.slow_window_s, tenant, priority)
        # a rule only counts when its window holds enough events to
        # mean something — min_events gates flapping on thin traffic
        rule = ""
        if n_fast >= obj.min_events and burn_fast >= obj.fast_burn:
            rule = "fast"
        elif n_slow >= obj.min_events and burn_slow >= obj.slow_burn:
            rule = "slow"
        with self._lock:
            st = self._alerts.get((obj.name, key))
            if st is None:
                if not rule and n_slow == 0:
                    return None      # nothing to track yet
                st = self._alerts[(obj.name, key)] = _AlertState()
            st.burn_fast, st.burn_slow = burn_fast, burn_slow
            st.attainment = 1.0 - err_slow
            st.events = n_slow
            prev = st.state
            if rule:
                st.breach_streak += 1
                st.clear_streak = 0
                st.rule = rule
                if st.state == "inactive":
                    st.state, st.since = "pending", now
                elif (st.state == "pending"
                      and st.breach_streak >= obj.fire_ticks):
                    st.state, st.since = "firing", now
            else:
                st.clear_streak += 1
                st.breach_streak = 0
                if st.state == "pending":
                    st.state, st.since, st.rule = "inactive", None, ""
                elif (st.state == "firing"
                      and st.clear_streak >= obj.resolve_ticks):
                    st.state, st.since = "inactive", None
            if st.state == prev:
                return None
            to = "resolved" if (prev == "firing"
                                and st.state == "inactive") else st.state
            return {"t": now, "objective": obj.name, "key": key,
                    "from": prev, "to": to, "rule": st.rule or rule,
                    "burn_fast": round(burn_fast, 4),
                    "burn_slow": round(burn_slow, 4),
                    "attainment": round(st.attainment, 6)}

    # -- reading -------------------------------------------------------------
    def firing(self) -> list:
        """The standing firing set — the autoscaler's ``firing_alerts``
        policy-input field."""
        with self._lock:
            return [{"objective": name, "key": key, "rule": st.rule,
                     "since": st.since}
                    for (name, key), st in sorted(self._alerts.items())
                    if st.state == "firing"]

    def state(self) -> list:
        """Last-evaluated metrics for every tracked (objective, key)."""
        with self._lock:
            return [{"objective": name, "key": key, "state": st.state,
                     "rule": st.rule, "since": st.since,
                     "burn_fast": round(st.burn_fast, 4),
                     "burn_slow": round(st.burn_slow, 4),
                     "attainment": round(st.attainment, 6),
                     "budget_remaining": round(
                         max(0.0, 1.0 - st.burn_slow), 4),
                     "events": st.events}
                    for (name, key), st in sorted(self._alerts.items())]


class IncidentStore:
    """Ring-bounded on-disk incident bundles — one JSON file each,
    written atomically (tmp + rename) so a reader racing a mid-kill
    writer always sees either nothing or complete JSON."""

    def __init__(self, dir: str | None = None, max_incidents: int = 32):
        self._dir = dir or os.environ.get("PADDLE_TPU_INCIDENT_DIR") or \
            os.path.join(tempfile.gettempdir(), "paddle_tpu_incidents")
        self.max_incidents = max(1, int(max_incidents))
        self._lock = threading.Lock()
        self._seq = 0
        self._meta: deque = deque(maxlen=self.max_incidents)

    @property
    def dir(self) -> str:
        return self._dir

    def write(self, bundle: dict) -> str:
        """Assigns an id, writes the bundle, prunes beyond the ring
        bound.  Returns the incident id."""
        with self._lock:
            self._seq += 1
            objective = str(bundle.get("incident", {})
                            .get("objective", "slo"))
            safe = "".join(c if c.isalnum() or c in "-_" else "-"
                           for c in objective)[:48]
            inc_id = f"inc-{int(time.time() * 1e3)}-{self._seq:04d}-{safe}"
            bundle.setdefault("incident", {})["id"] = inc_id
            os.makedirs(self._dir, exist_ok=True)
            path = os.path.join(self._dir, f"{inc_id}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(bundle, f, indent=2, default=str)
            os.replace(tmp, path)
            if len(self._meta) == self._meta.maxlen:
                old = self._meta[0]
                try:
                    os.remove(os.path.join(self._dir, f"{old['id']}.json"))
                except OSError:
                    pass
            self._meta.append({
                "id": inc_id,
                "objective": objective,
                "key": bundle.get("incident", {}).get("key"),
                "rule": bundle.get("incident", {}).get("rule"),
                "t": bundle.get("incident", {}).get("t"),
                "time": bundle.get("time"),
                "path": path,
            })
            return inc_id

    def list(self) -> list:
        with self._lock:
            return [dict(m) for m in self._meta]

    def get(self, inc_id: str) -> dict | None:
        with self._lock:
            match = next((m for m in self._meta if m["id"] == inc_id), None)
        if match is None:
            return None
        try:
            with open(match["path"]) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None


def build_incident(transition: dict, *, gateway=None, window=None,
                   n_journeys: int = 5) -> dict:
    """One incident bundle correlating all three telemetry planes at
    the moment an alert fired: the watchdog base (flight tail, open
    spans, thread stacks, registered sections — perfscope's device
    memory ledger and the traffic recorder's ``capture_tail`` (the
    last arrivals before the burn, admitted and shed, each resolvable
    against ``/debug/requests`` by journey id) ride in via their
    ``add_section`` providers), keyed
    window snapshots, the N slowest journey timelines in-window, the
    perfscope roofline + memory report, and ``fleet_stats()``.  Every
    plane is individually guarded: a failing provider drops its section
    rather than the incident."""
    bundle = watchdog.collect(
        f"slo_alert:{transition.get('objective', '?')}")
    bundle["schema"] = INCIDENT_SCHEMA
    bundle["incident"] = {
        "objective": transition.get("objective"),
        "key": transition.get("key"),
        "rule": transition.get("rule"),
        "burn_fast": transition.get("burn_fast"),
        "burn_slow": transition.get("burn_slow"),
        "attainment": transition.get("attainment"),
        "t": transition.get("t"),
        "time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
    }
    if window is not None:
        try:
            bundle["window"] = {
                "global": window.snapshot(),
                "by_tenant": window.snapshot(by="tenant"),
                "by_class": window.snapshot(by="class"),
            }
        except Exception:  # noqa: BLE001 — plane is optional
            pass
    try:
        recent = journey_mod.recent(256)
        recent.sort(key=lambda j: j.wall_s or 0.0, reverse=True)
        bundle["slowest_journeys"] = [
            j.timeline() for j in recent[:max(0, int(n_journeys))]]
    except Exception:  # noqa: BLE001
        pass
    try:
        from . import perfscope
        bundle["perf"] = perfscope.perf_report()
        bundle["memory"] = perfscope.memory_report()
    except Exception:  # noqa: BLE001
        pass
    if gateway is not None:
        try:
            bundle["fleet"] = gateway.fleet_stats()
        except Exception:  # noqa: BLE001
            pass
    return bundle


class SloEngine:
    """The live evaluator: attaches to a gateway, polls its keyed
    window at ``tick_s`` on a daemon thread, exports gauges, records
    ``"alert"`` flight events, and snapshots an incident bundle on each
    transition to firing.  ``tick()`` is also callable directly (tests,
    smoke lanes) — the thread is just a clock."""

    def __init__(self, gateway, objectives, *, tick_s: float = 1.0,
                 evaluator: SloEvaluator | None = None,
                 store: IncidentStore | None = None,
                 incident_dir: str | None = None, max_incidents: int = 32,
                 incident_journeys: int = 5, start: bool = True):
        # accept a GatewayStack or a bare Gateway
        self.gateway = getattr(gateway, "gateway", gateway)
        self.evaluator = evaluator or SloEvaluator(objectives)
        self.store = store or IncidentStore(incident_dir, max_incidents)
        self.tick_s = max(0.05, float(tick_s))
        self.incident_journeys = int(incident_journeys)
        self._lock = threading.Lock()
        self._transitions: deque = deque(maxlen=256)
        self._ticks = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        attach = getattr(self.gateway, "attach_slo_engine", None)
        if attach is not None:
            attach(self)
        if start:
            self._thread = threading.Thread(
                target=self._run, name="slo-engine", daemon=True)
            self._thread.start()

    # -- the clock -----------------------------------------------------------
    def _run(self):
        while not self._stop.wait(self.tick_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the clock must survive
                pass

    def tick(self, now: float | None = None) -> list:
        """One evaluation: refresh the gateway's windowed gauges, step
        the burn-rate machine, export SLO gauges, handle transitions."""
        try:
            self.gateway.window_stats()
        except Exception:  # noqa: BLE001 — gauges are best-effort
            pass
        window = self.gateway.window
        transitions = self.evaluator.tick(window, now=now)
        # publish the tail BEFORE the export/incident work below: a
        # debug reader that already sees the new alert state must also
        # see its transition (copies — incident ids attach to the
        # originals later, and the tail must not mutate under a
        # concurrent JSON dump)
        with self._lock:
            self._ticks += 1
            self._transitions.extend(dict(tr) for tr in transitions)
        reg = registry()
        att = reg.gauge(SLO_ATTAINMENT,
                        "windowed fraction of good events per objective")
        budget = reg.gauge(SLO_BUDGET_REMAINING,
                           "1 - slow-window burn rate, clamped at 0")
        burn = reg.gauge(SLO_BURN_RATE,
                         "error budget burn multiple per window")
        for row in self.evaluator.state():
            labels = {"objective": row["objective"], "key": row["key"]}
            att.set(row["attainment"], labels=labels)
            budget.set(row["budget_remaining"], labels=labels)
            burn.set(row["burn_fast"], labels=dict(labels, window="fast"))
            burn.set(row["burn_slow"], labels=dict(labels, window="slow"))
        alerts = reg.counter(SLO_ALERTS, "alert lifecycle transitions")
        for tr in transitions:
            alerts.inc(labels={"objective": tr["objective"],
                               "state": tr["to"]})
            flight.record("alert", tr["to"], objective=tr["objective"],
                          key=tr["key"], rule=tr["rule"],
                          burn_fast=tr["burn_fast"],
                          burn_slow=tr["burn_slow"],
                          attainment=tr["attainment"])
            if tr["to"] == "firing":
                try:
                    bundle = build_incident(
                        tr, gateway=self.gateway, window=window,
                        n_journeys=self.incident_journeys)
                    tr["incident_id"] = self.store.write(bundle)
                except Exception:  # noqa: BLE001 — never kill the tick
                    pass
        return transitions

    # -- reading / lifecycle -------------------------------------------------
    def firing(self) -> list:
        return self.evaluator.firing()

    def debug_state(self) -> dict:
        """The ``GET /debug/slo`` payload."""
        with self._lock:
            ticks = self._ticks
            tail = list(self._transitions)[-32:]
        return {
            "tick_s": self.tick_s,
            "ticks": ticks,
            "objectives": [o.snapshot() for o in self.evaluator.objectives],
            "alerts": self.evaluator.state(),
            "firing": self.evaluator.firing(),
            "transitions": tail,
            "incidents": self.store.list(),
        }

    def shutdown(self, timeout_s: float = 5.0):
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=timeout_s)
