"""Admission — priority classes and per-tenant weighted fair-share queues.

This layer replaces the engine's single FIFO as the traffic-facing queue:
every tenant gets its own bounded FIFO, tenants inside one priority class
share capacity by *weighted fair queuing* (start-time virtual clocks over
estimated token cost), and priority classes are strict — an
``interactive`` item is always dispatched before a ``standard`` one,
which beats ``batch``.  One greedy tenant can therefore fill only its own
queue (structured 429 beyond its cap), never another tenant's latency.

The scheduler is a passive, lock+condition protected structure: HTTP
handler threads ``enqueue()``, the gateway's single dispatcher thread
``pop()``s runnable work and ``release()``s a tenant's concurrency unit
when its request finishes.  Virtual time bookkeeping:

* each pop advances the tenant's clock by ``cost / weight`` where cost is
  the request's estimated token work (prompt + max_tokens) — a tenant
  sending few small requests outpaces one sending many large ones at
  equal weight;
* a tenant going idle -> active fast-forwards its clock to the tier's
  minimum active clock, so idleness banks no credit (standard SFQ
  behavior).
"""
from __future__ import annotations

import threading
import time
from collections import deque

from .protocol import PRIORITIES

__all__ = ["AdmissionError", "TenantConfig", "FairShareScheduler"]


class AdmissionError(Exception):
    """Structured 429: the admission layer refused the request.  Carries
    the machine-readable reason (``tenant_queue_full`` /
    ``tenant_concurrency`` / ``gateway_queue_full`` / ``slo_shed``) and a
    ``Retry-After`` hint in seconds."""

    status = 429

    def __init__(self, reason: str, message: str, *,
                 retry_after_s: float = 1.0, tenant: str | None = None,
                 est_ttft_s: float | None = None):
        super().__init__(message)
        self.reason = reason
        self.retry_after_s = max(0.0, float(retry_after_s))
        self.tenant = tenant
        self.est_ttft_s = est_ttft_s


class TenantConfig:
    """Per-tenant admission policy.  ``weight`` shares capacity inside the
    priority class; ``max_queue`` bounds the tenant's own FIFO (429
    beyond); ``max_concurrency`` caps the tenant's in-flight requests
    (queued work waits, other tenants proceed)."""

    __slots__ = ("name", "weight", "priority", "max_queue",
                 "max_concurrency")

    def __init__(self, name: str, *, weight: float = 1.0,
                 priority: str = "standard", max_queue: int = 16,
                 max_concurrency: int | None = None):
        if priority not in PRIORITIES:
            raise ValueError(f"unknown priority {priority!r} "
                             f"(one of {sorted(PRIORITIES)})")
        if float(weight) <= 0:
            raise ValueError("weight must be > 0")
        if int(max_queue) < 1:
            raise ValueError("max_queue must be >= 1")
        self.name = name
        self.weight = float(weight)
        self.priority = priority
        self.max_queue = int(max_queue)
        self.max_concurrency = (None if max_concurrency is None
                                else int(max_concurrency))


class _TenantState:
    __slots__ = ("cfg", "q", "vtime", "in_flight", "inflight_cost",
                 "enqueued_total", "rejected_total")

    def __init__(self, cfg: TenantConfig):
        self.cfg = cfg
        self.q: deque = deque()
        self.vtime = 0.0
        self.in_flight = 0
        self.inflight_cost = 0.0
        self.enqueued_total = 0
        self.rejected_total = 0


class FairShareScheduler:
    """Priority tiers of weighted-fair per-tenant queues (see module
    docstring).  Items need ``tenant`` (str), ``cost`` (float tokens) and
    ``priority`` (a PRIORITIES key) attributes."""

    def __init__(self, tenants=None, *, default: TenantConfig | None = None,
                 max_queue_total: int | None = None):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._default = default or TenantConfig("default")
        self._tenants: dict[str, _TenantState] = {}
        self._closed = False
        self.max_queue_total = max_queue_total
        for cfg in (tenants or ()):
            self._tenants[cfg.name] = _TenantState(cfg)

    # -- configuration -------------------------------------------------------
    def configure(self, cfg: TenantConfig):
        """Add/replace one tenant's policy (existing queue is kept)."""
        with self._lock:
            st = self._tenants.get(cfg.name)
            if st is None:
                self._tenants[cfg.name] = _TenantState(cfg)
            else:
                st.cfg = cfg

    def _state_locked(self, name: str) -> _TenantState:
        st = self._tenants.get(name)
        if st is None:
            d = self._default
            st = self._tenants[name] = _TenantState(TenantConfig(
                name, weight=d.weight, priority=d.priority,
                max_queue=d.max_queue, max_concurrency=d.max_concurrency))
        return st

    def tenant_config(self, name: str) -> TenantConfig:
        with self._lock:
            return self._state_locked(name).cfg

    # -- producer side (HTTP handler threads) --------------------------------
    def enqueue(self, item):
        """Queue one work item under its tenant's caps; raises
        :class:`AdmissionError` (429) at the tenant/gateway bound."""
        with self._lock:
            if self._closed:
                raise AdmissionError(
                    "gateway_closed", "gateway is shutting down",
                    retry_after_s=5.0, tenant=item.tenant)
            st = self._state_locked(item.tenant)
            if len(st.q) >= st.cfg.max_queue:
                st.rejected_total += 1
                raise AdmissionError(
                    "tenant_queue_full",
                    f"tenant {item.tenant!r} queue is full "
                    f"({st.cfg.max_queue}); retry later",
                    retry_after_s=self._drain_eta_locked(st),
                    tenant=item.tenant)
            if self.max_queue_total is not None and \
                    self._depth_locked() >= self.max_queue_total:
                st.rejected_total += 1
                raise AdmissionError(
                    "gateway_queue_full",
                    f"gateway queue is full ({self.max_queue_total})",
                    retry_after_s=1.0, tenant=item.tenant)
            if not st.q and st.in_flight == 0:
                # idle -> active: no banked credit from the idle period
                active = [t.vtime for t in self._tenants.values()
                          if t is not st and (t.q or t.in_flight)]
                if active:
                    st.vtime = max(st.vtime, min(active))
            st.q.append(item)
            st.enqueued_total += 1
            self._cv.notify()

    def _drain_eta_locked(self, st: _TenantState) -> float:
        # crude Retry-After for a full tenant queue: one queue-slot's
        # worth of this tenant's round-share; the shed layer gives the
        # telemetry-driven estimate, this is just a floor
        return max(0.25, 0.05 * len(st.q))

    # -- consumer side (the gateway dispatcher thread) -----------------------
    def pop(self, timeout: float | None = None):
        """Next runnable item by (priority tier, fair-share clock), or
        None on timeout/close.  Increments the tenant's in-flight count —
        pair every pop with :meth:`release` (or :meth:`requeue`)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                if self._closed:
                    return None
                st = self._runnable_locked()
                if st is not None:
                    item = st.q.popleft()
                    st.vtime += item.cost / st.cfg.weight
                    st.in_flight += 1
                    st.inflight_cost += item.cost
                    return item
                if deadline is None:
                    self._cv.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    self._cv.wait(remaining)

    def _runnable_locked(self) -> _TenantState | None:
        best, best_key = None, None
        for name in sorted(self._tenants):
            st = self._tenants[name]
            if not st.q:
                continue
            cap = st.cfg.max_concurrency
            if cap is not None and st.in_flight >= cap:
                continue
            # tier comes from the item at the head of the tenant's FIFO,
            # so a per-request priority override is honored without
            # reordering the tenant's own queue
            key = (PRIORITIES[st.q[0].priority], st.vtime, name)
            if best_key is None or key < best_key:
                best, best_key = st, key
        return best

    def requeue(self, item):
        """Put a popped item back at the FRONT of its tenant queue and
        roll back the pop's accounting (dispatch found no engine room)."""
        with self._lock:
            st = self._state_locked(item.tenant)
            st.q.appendleft(item)
            st.vtime -= item.cost / st.cfg.weight
            st.in_flight -= 1
            st.inflight_cost -= item.cost
            self._cv.notify()

    def release(self, tenant: str, cost: float):
        """A popped item finished on the engine side: free the tenant's
        concurrency unit and retire its in-flight cost."""
        with self._lock:
            st = self._state_locked(tenant)
            st.in_flight = max(0, st.in_flight - 1)
            st.inflight_cost = max(0.0, st.inflight_cost - float(cost))
            self._cv.notify()

    # -- introspection -------------------------------------------------------
    def _depth_locked(self) -> int:
        return sum(len(st.q) for st in self._tenants.values())

    def depth(self) -> int:
        with self._lock:
            return self._depth_locked()

    def depths(self) -> dict:
        """{tenant: {queued, in_flight, vtime, enqueued, rejected}}."""
        with self._lock:
            return {name: {"queued": len(st.q), "in_flight": st.in_flight,
                           "vtime": round(st.vtime, 3),
                           "enqueued": st.enqueued_total,
                           "rejected": st.rejected_total}
                    for name, st in self._tenants.items()}

    def backlog_cost(self, priority: str) -> float:
        """Token-cost of work that would run BEFORE a new request of
        `priority`: queued items at the same or higher class plus ALL
        in-flight cost (the shed layer's queue-ahead term)."""
        tier = PRIORITIES[priority]
        with self._lock:
            total = 0.0
            for st in self._tenants.values():
                total += st.inflight_cost
                total += sum(i.cost for i in st.q
                             if PRIORITIES[i.priority] <= tier)
            return total

    # -- shutdown ------------------------------------------------------------
    def drain(self) -> list:
        """Remove and return every queued item (shutdown: the gateway
        fails them with 503)."""
        with self._lock:
            out = []
            for st in self._tenants.values():
                out.extend(st.q)
                st.q.clear()
            return out

    def close(self):
        with self._lock:
            self._closed = True
            self._cv.notify_all()
