"""Router — spread tenants across N engine replicas, fail over from DEAD.

Replica scale-out for the serving path: the gateway dispatches each
admitted request to the **least-loaded alive** engine, load being the
O(1) ``Engine.load()`` snapshot (slot occupancy + engine-side queue
depth).  An engine whose scheduler crashed reports ``alive: False``
(``EngineDeadError``) and is simply never picked again —
the remaining replicas absorb its traffic; with every replica dead the
router raises :class:`NoEngineAvailableError` (HTTP 503).

Membership is DYNAMIC (the autoscaler's substrate):
:meth:`add_replica` / :meth:`remove_replica` mutate the replica set
under the router's lock, safe against a dispatcher mid-``pick`` and the
reaper's cross-replica redispatch — both iterate a snapshot.  A replica
whose ``load()`` reports ``draining`` is a THIRD state: not pickable
(no new work, so parked zero-token requests never redispatch onto a
replica that is leaving) but NOT dead — :meth:`any_draining` lets the
gateway keep queued work parked instead of 503-ing while the only other
capacity is mid-cold-build.  Removing a replica deletes its per-engine
gauge series (``paddle_tpu_gateway_engine_slots_in_use{engine=...}``)
instead of freezing them at the last value.

Each replica also carries a **revision** label: a rollout
controller tags the replicas it builds with the target revision, so
``/debug/fleet`` and ``paddle_tpu_fleet_replicas_alive{revision=...}``
show exactly which builds are serving at any instant of an upgrade —
and the no-mixed-revision-steady-state invariant is assertable.  When
two alive replicas both have headroom, :meth:`pick` prefers the one
whose adapter bank already holds the request's LoRA adapter
(``adapter=``, the locality tiebreak): residency beats least-loaded
once cold loads dominate TTFT, and with no adapter (or no resident
replica with room) the ordering is exactly the pre-locality one.
"""
from __future__ import annotations

import threading

from ...observability import registry
from ..fleet_metrics import FLEET_ALIVE

__all__ = ["NoEngineAvailableError", "EngineRouter"]

GATEWAY_ENGINE_SLOTS = "paddle_tpu_gateway_engine_slots_in_use"
GATEWAY_ENGINES_ALIVE = "paddle_tpu_gateway_engines_alive"


class NoEngineAvailableError(RuntimeError):
    """Every replica is dead or shut down — the gateway answers 503."""


class EngineRouter:
    """Least-loaded routing over a dynamic set of engine replicas."""

    def __init__(self, engines, names=None, revision: str = "r0"):
        engines = list(engines)
        if not engines:
            raise ValueError("router needs at least one engine")
        if names is None:
            names = [f"engine{i}" for i in range(len(engines))]
        if len(names) != len(engines) or len(set(names)) != len(names):
            raise ValueError("names must be unique, one per engine")
        self._lock = threading.Lock()
        self._engines = list(zip(list(names), engines))
        self._revisions = {n: str(revision) for n in names}

    def _snapshot(self) -> list:
        with self._lock:
            return list(self._engines)

    # -- membership (autoscaler control thread vs dispatcher/reaper) ---------
    def add_replica(self, name: str, engine, revision: str = "r0"):
        """Add one replica under the router's lock; the dispatcher's next
        ``pick``/``has_headroom`` sees it immediately.  ``revision``
        tags the build (the rollout controller's label; scale-ups tag
        the fleet's current revision)."""
        name = str(name)
        with self._lock:
            if any(n == name for n, _ in self._engines):
                raise ValueError(f"replica name {name!r} already routed")
            self._engines.append((name, engine))
            self._revisions[name] = str(revision)

    def remove_replica(self, name: str):
        """Remove one replica (returns its engine) and DELETE its
        per-engine gauge series — a removed replica must vanish from the
        dashboard, not freeze at its last occupancy.  Raises KeyError on
        an unknown name; refuses to empty the router."""
        with self._lock:
            idx = next((i for i, (n, _) in enumerate(self._engines)
                        if n == name), None)
            if idx is None:
                raise KeyError(f"no replica named {name!r}")
            if len(self._engines) == 1:
                raise ValueError("refusing to remove the last replica")
            _, eng = self._engines.pop(idx)
            self._revisions.pop(name, None)
        registry().gauge(GATEWAY_ENGINE_SLOTS,
                         "per-replica slots owned by requests").remove(
            labels={"engine": name})
        return eng

    def revisions(self) -> dict:
        """{replica name: revision label} for the current membership."""
        with self._lock:
            return dict(self._revisions)

    def revision_of(self, name: str) -> str:
        with self._lock:
            return self._revisions.get(name, "r0")

    @property
    def engines(self) -> list:
        return [e for _, e in self._snapshot()]

    @property
    def names(self) -> list:
        return [n for n, _ in self._snapshot()]

    def loads(self) -> dict:
        """{name: Engine.load() snapshot} for every replica; also refreshes
        the per-engine occupancy gauges (and drops series for replicas
        that left the router since the last refresh)."""
        reg = registry()
        out = {}
        alive = 0
        current = self._snapshot()
        revs = self.revisions()
        gauge = reg.gauge(GATEWAY_ENGINE_SLOTS,
                          "per-replica slots owned by requests")
        by_rev: dict = {}
        for name, eng in current:
            ld = eng.load()
            out[name] = ld
            alive += bool(ld["alive"])
            gauge.set(float(ld["slots_in_use"]), labels={"engine": name})
            if ld["alive"] and not ld.get("draining"):
                rev = revs.get(name, "r0")
                by_rev[rev] = by_rev.get(rev, 0) + 1
        # sweep series whose engine is no longer routed (a remove_replica
        # racing this refresh can re-export a stale series for one poll)
        routed = {name for name, _ in current}
        for labels, _ in gauge.series():
            name = labels.get("engine")
            if name is not None and name not in routed:
                gauge.remove(labels={"engine": name})
        reg.gauge(GATEWAY_ENGINES_ALIVE, "replicas able to take work").set(
            float(alive))
        # the revision-labelled fleet view: which builds are
        # serving right now — mid-rollout both revisions export, at the
        # steady state exactly one does (stale revisions are swept, the
        # autoscaler's unlabelled series is left alone)
        alive_g = reg.gauge(FLEET_ALIVE, "alive, non-draining replicas")
        for rev, n in by_rev.items():
            alive_g.set(float(n), labels={"revision": rev})
        for labels, _ in alive_g.series():
            rev = labels.get("revision")
            if rev is not None and rev not in by_rev:
                alive_g.remove(labels={"revision": rev})
        return out

    def pick(self, exclude=(), adapter: str | None = None) -> tuple:
        """(name, engine) of the least-loaded alive replica (slot
        occupancy first, engine queue depth as the tiebreak); raises
        :class:`NoEngineAvailableError` when none qualifies.  Draining
        replicas are never picked — new work (including redispatched
        parked work) must not land on a replica that is leaving.

        ``adapter`` is the locality tiebreak: a replica
        whose bank already holds the request's LoRA adapter AND has a
        free slot wins over a colder least-loaded one — the dispatch
        skips the admission-time cold load.  Residency never overrides
        backpressure: a resident replica with its slot pool full falls
        back into the ordinary least-loaded order."""
        best = None
        best_key = None
        for name, eng in self._snapshot():
            if name in exclude:
                continue
            ld = eng.load()
            if not ld["alive"] or ld.get("draining"):
                continue
            local = False
            if adapter is not None:
                probe = getattr(eng, "adapter_resident", None)
                if probe is not None:
                    try:
                        local = (bool(probe(adapter)) and
                                 ld["slots_in_use"] + ld["queue_depth"]
                                 < ld["max_slots"])
                    except Exception:  # noqa: BLE001 — locality is a hint
                        local = False
            key = (0 if local else 1,
                   ld["slots_in_use"] + ld["queue_depth"],
                   ld["queue_depth"], name)
            if best_key is None or key < best_key:
                best, best_key = (name, eng), key
        if best is None:
            raise NoEngineAvailableError(
                "no alive engine replica (all dead, excluded, or shut down)")
        return best

    def any_alive(self) -> bool:
        return any(eng.load()["alive"] for _, eng in self._snapshot())

    def any_draining(self) -> bool:
        """True while some replica is draining — a third state between
        alive and dead: it takes no new work but its in-flight work is
        finishing, so the gateway parks queued work instead of failing
        it (no spurious 503 while the only other replica is
        mid-cold-build)."""
        return any(eng.load().get("draining")
                   for _, eng in self._snapshot())

    def has_headroom(self, slack: int = 1) -> bool:
        """True when some alive replica can take one more request without
        queuing deeper than `slack` behind its slot pool — the dispatcher
        gate that keeps ordering decisions IN the gateway's fair-share
        queues instead of an engine FIFO."""
        for _, eng in self._snapshot():
            ld = eng.load()
            if ld["alive"] and not ld.get("draining") and \
                    ld["slots_in_use"] + ld["queue_depth"] < \
                    ld["max_slots"] + slack:
                return True
        return False

    def total_slots(self) -> int:
        """Aggregate decode parallelism of the alive replicas (the shed
        formula's drain rate denominator)."""
        total = 0
        for _, eng in self._snapshot():
            ld = eng.load()
            if ld["alive"] and not ld.get("draining"):
                total += ld["max_slots"]
        return total or 1

    def min_max_len(self) -> int:
        """Tightest per-request length bound across alive replicas (admission
        validates prompt+max_tokens against this)."""
        engines = self._snapshot()
        lens = [e.max_len for _, e in engines if e.load()["alive"]]
        return min(lens) if lens else min(e.max_len for _, e in engines)
