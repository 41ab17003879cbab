"""Gateway core — admission, shedding, dispatch over engine replicas.

The traffic path, socket to slot pool::

    HTTP handler threads (http.py)
        parse -> tenant -> Gateway.admit()
                     |         |-- shed check (LoadShedder: est TTFT vs
                     |         |   deadline) -> 429 + Retry-After
                     |         `-- FairShareScheduler.enqueue (per-tenant
                     |             caps -> structured 429)
                     |  wait/stream on the GatewayRequest
        dispatcher thread (one per gateway)
            pop fair-share winner -> EngineRouter.pick (least loaded,
            skips DEAD replicas) -> Engine.submit(stream=token queue)
            reap finished handles -> release tenant slot, feed the
            shedder's EWMAs, per-tenant TTFT histograms

The port's copy of ``paddle_tpu/serving/gateway/gateway.py``.
Thread-shape invariants: every handler<->dispatcher handoff crosses on a
``queue.Queue``/``threading.Event`` or inside the scheduler's lock; the
dispatcher's outstanding-request list is a local variable of its loop,
shared with nobody.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time

import numpy as np

from ...observability import capture as capture_mod
from ...observability import flight, registry
from ...observability.journey import TelemetryWindow
from ...testing import faults
from ..engine import (SERVING_REDISPATCHED, EngineDeadError, QueueFullError,
                      RequestInterruptedError)
from .admission import AdmissionError, FairShareScheduler, TenantConfig
from .protocol import PRIORITIES, CompletionRequest, ProtocolError
from .router import EngineRouter, NoEngineAvailableError
from .shed import LoadShedder

__all__ = ["Gateway", "GatewayClosedError", "GatewayRequest"]

# -- metric names (paddle_tpu_torch.observability registry) -------------------
GATEWAY_REQUESTS = "paddle_tpu_gateway_requests_total"
GATEWAY_QUEUE_DEPTH = "paddle_tpu_gateway_queue_depth"
GATEWAY_INFLIGHT = "paddle_tpu_gateway_inflight"
GATEWAY_TTFT = "paddle_tpu_gateway_ttft_seconds"
GATEWAY_TTFT_EST = "paddle_tpu_gateway_ttft_estimate_seconds"
GATEWAY_SHED = "paddle_tpu_gateway_shed_total"

_ids = itertools.count(1)


class GatewayClosedError(RuntimeError):
    """The gateway shut down with this request still queued (503)."""


class GatewayRequest:
    """One admitted request crossing the handler/dispatcher boundary.

    The handler thread blocks on :attr:`ready` (first dispatch or early
    failure — ``handle``/``error`` are written before the event is set,
    which publishes them) and then on :attr:`done_ev` for the FINAL
    outcome; streamed tokens arrive on :attr:`token_q` from the engine's
    scheduler thread.  The dispatcher's reaper is the single authority
    on the final outcome: an engine death may replace :attr:`handle`
    with a re-dispatched one (safe only while no token has reached the
    client), so handlers never treat a handle failure as final — they
    wait for :meth:`finish`.
    """

    __slots__ = ("id", "creq", "tenant", "priority", "cost", "prompt",
                 "t_enqueue", "t_dispatch", "token_q", "ready", "handle",
                 "error", "engine_name", "deadline", "done_ev",
                 "final_error", "redispatches", "adapter", "journey",
                 "t_queue0", "t_first_token")

    def __init__(self, creq: CompletionRequest, tenant: str, priority: str,
                 prompt: np.ndarray, adapter: str | None = None,
                 journey=None):
        self.id = f"cmpl-{next(_ids)}"
        self.creq = creq
        self.tenant = tenant
        self.priority = priority
        self.prompt = prompt
        self.adapter = adapter       # LoRA adapter name (model= resolved)
        self.journey = journey       # observability Journey (or None)
        self.cost = float(prompt.size + creq.max_tokens)
        now = time.perf_counter()
        self.t_enqueue = now
        self.t_queue0 = now          # current queue-wait window start
        self.t_first_token: float | None = None
        self.t_dispatch: float | None = None
        self.deadline = (None if creq.deadline_s is None
                         else now + creq.deadline_s)
        self.token_q: queue.Queue = queue.Queue()
        self.ready = threading.Event()
        self.done_ev = threading.Event()
        self.handle = None
        self.error: BaseException | None = None
        self.final_error: BaseException | None = None
        self.engine_name: str | None = None
        self.redispatches = 0

    def fail(self, error: BaseException):
        """Final failure before (or instead of) a dispatch."""
        self.error = error
        self.final_error = error
        self.ready.set()
        self.done_ev.set()

    def finish(self, error: BaseException | None = None):
        """Final outcome after a dispatch (reaper only)."""
        self.final_error = error
        self.done_ev.set()

    def dispatched(self, handle, engine_name: str):
        self.handle = handle
        self.engine_name = engine_name
        self.t_dispatch = time.perf_counter()
        self.ready.set()


class Gateway:
    """Multi-tenant front door over one or more serving engines.

    Args:
        engines: Engine replica(s) — the gateway does NOT own them; shut
            them down separately (or use ``start_gateway`` from http.py,
            whose ``close()`` tears the whole stack down).
        tenants: iterable of :class:`TenantConfig` (unknown tenants get
            ``default_tenant``'s policy).
        default_tenant: policy template for unconfigured tenants.
        api_keys: optional {key: tenant} map; when set, requests without a
            known key are 401 (strict mode).
        names: router replica names (default engine0..N-1).
        shedder: optionally pre-seeded :class:`LoadShedder`.
        max_queue_total: global queued-request bound across tenants.
        dispatch_slack: how deep past the slot pool the dispatcher lets an
            engine's own queue grow (small = ordering stays fair-share).
        max_redispatch: gateway-side retry budget for requests whose
            engine died before any token reached the client (engine
            replacements on ANOTHER replica; a supervisor's same-handle
            re-dispatches have their own budget).
        window_s: trailing window of the :class:`TelemetryWindow` feed
            behind :meth:`window_stats` (queue-wait/TTFT/per-token
            percentiles, shed rate, per-phase time shares — the
            closed-loop autoscaler input).
        model_name: echoed in completion responses.
        start: start the dispatcher thread immediately (tests stage
            queues deterministically with False, then call start()).
    """

    def __init__(self, engines, tenants=None, *,
                 default_tenant: TenantConfig | None = None,
                 api_keys: dict | None = None, names=None,
                 shedder: LoadShedder | None = None,
                 max_queue_total: int | None = None, dispatch_slack: int = 1,
                 max_redispatch: int = 2, window_s: float = 60.0,
                 model_name: str = "paddle-tpu", start: bool = True,
                 capture=None, capture_mode: str | None = None,
                 capture_entries: int | None = None,
                 capture_spill_dir: str | None = None):
        if hasattr(engines, "submit"):
            engines = [engines]
        self.router = EngineRouter(engines, names=names)
        self.scheduler = FairShareScheduler(
            tenants, default=default_tenant, max_queue_total=max_queue_total)
        self.shedder = shedder or LoadShedder()
        self.window = TelemetryWindow(window_s=window_s)
        self.api_keys = dict(api_keys) if api_keys else None
        self.model_name = model_name
        self.dispatch_slack = int(dispatch_slack)
        self.max_redispatch = int(max_redispatch)
        self.tokenizer = next(
            (e.tokenizer for e in self.router.engines
             if e.tokenizer is not None), None)
        # multi-LoRA: `model=` names resolve through the replicas' shared
        # adapter registry (tenant -> adapter is the natural mapping; a
        # request without model=, or naming the base model, runs id 0)
        self.adapter_registry = next(
            (getattr(e, "adapter_registry", None)
             for e in self.router.engines
             if getattr(e, "adapter_registry", None) is not None), None)
        # traffic capture: an explicit instance or any knob builds a
        # gateway-local recorder (tests, spill-to-dir deployments);
        # otherwise every gateway records into the process default.
        # Either way the recorder feeds the capture_tail bundle section.
        if capture is not None:
            self.capture = capture
            capture_mod.install_incident_section(capture)
        elif (capture_mode is not None or capture_entries is not None
              or capture_spill_dir is not None):
            self.capture = capture_mod.TrafficCapture(
                max_entries=capture_entries, mode=capture_mode,
                spill_dir=capture_spill_dir)
            capture_mod.install_incident_section(self.capture)
        else:
            self.capture = capture_mod.get_capture()
        self._stop_ev = threading.Event()
        self._drain_ev = threading.Event()
        self._drain_retry_after_s = 5.0
        self._dispatcher_error: BaseException | None = None
        self._thread: threading.Thread | None = None
        self._fleet_lock = threading.Lock()
        self._autoscaler = None
        self._slo_engine = None
        self._rollout = None
        if start:
            self.start()

    # -- fleet elasticity hooks ----------------------------------------------
    def attach_autoscaler(self, autoscaler):
        """Register the fleet autoscaler (one per gateway): admission
        treats a scale-up in flight as capacity-on-the-way (no all-dead
        503 while the only other replica drains), shed Retry-After is
        capped at the expected warm-up completion, and ``/debug/fleet``
        serves its state."""
        with self._fleet_lock:
            self._autoscaler = autoscaler

    @property
    def autoscaler(self):
        with self._fleet_lock:
            return self._autoscaler

    def attach_slo_engine(self, engine):
        """Register the SLO evaluator (one per gateway): its firing set
        feeds the autoscaler policy input (``firing_alerts``) and
        ``/debug/slo`` serves its state."""
        with self._fleet_lock:
            self._slo_engine = engine

    @property
    def slo_engine(self):
        with self._fleet_lock:
            return self._slo_engine

    def attach_rollout(self, controller):
        """Register the rolling-upgrade controller (one per gateway): a
        rollout build in flight counts as capacity-on-the-way (no
        all-dead 503 mid-upgrade), shed Retry-After is capped at its
        expected warm-up completion, the reaper feeds it per-engine
        canary outcomes, and ``/debug/fleet`` serves its state."""
        with self._fleet_lock:
            self._rollout = controller

    @property
    def rollout(self):
        with self._fleet_lock:
            return self._rollout

    def _fleet_pending(self) -> bool:
        """Capacity is leaving-but-finishing or on the way: some replica
        is DRAINING (its in-flight work completes; new work must wait,
        not 503), the autoscaler has a scale-up building, or the rollout
        controller is mid-build of a replacement replica."""
        a = self.autoscaler
        if a is not None and a.scale_pending():
            return True
        r = self.rollout
        if r is not None and r.build_pending():
            return True
        return self.router.any_draining()

    def _scale_eta_s(self) -> float | None:
        etas = []
        a = self.autoscaler
        if a is not None:
            eta = a.expected_ready_s()
            if eta is not None:
                etas.append(eta)
        r = self.rollout
        if r is not None:
            eta = r.expected_ready_s()
            if eta is not None:
                etas.append(eta)
        return min(etas) if etas else None

    def fleet_stats(self) -> dict:
        """The ``/debug/fleet`` payload: per-replica state from the
        router plus the autoscaler's view (bounds, desired count,
        in-flight op, recent scale events) and the rollout's block when
        they are attached."""
        loads = self.router.loads()
        revs = self.router.revisions()
        out = {
            "replicas": {
                name: {"alive": ld["alive"],
                       "draining": bool(ld.get("draining")),
                       "restarting": bool(ld.get("restarting")),
                       "slots_in_use": ld["slots_in_use"],
                       "queue_depth": ld["queue_depth"],
                       "max_slots": ld["max_slots"],
                       "revision": revs.get(name, "r0")}
                for name, ld in loads.items()},
            "alive": sum(1 for ld in loads.values()
                         if ld["alive"] and not ld.get("draining")),
            "draining": sum(1 for ld in loads.values()
                            if ld.get("draining")),
            "total_slots": self.router.total_slots(),
        }
        a = self.autoscaler
        out["autoscaler"] = a.fleet_stats() if a is not None else None
        r = self.rollout
        out["rollout"] = r.stats() if r is not None else None
        return out

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        if self._stop_ev.is_set():
            raise GatewayClosedError("gateway is shut down")
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._dispatch_loop, name="paddle-tpu-gateway",
                daemon=True)
            self._thread.start()

    def shutdown(self):
        """Stop dispatching; queued requests fail with
        :class:`GatewayClosedError` (503 at the wire).  Idempotent; does
        not shut the engines down."""
        if self._stop_ev.is_set():
            return
        self._stop_ev.set()
        self.scheduler.close()
        if self._thread is not None:
            self._thread.join(timeout=10)
        err = GatewayClosedError("gateway shut down")
        for item in self.scheduler.drain():
            item.fail(err)
            self._count(item.tenant, "failed")
        flight.record("gateway", "shutdown")

    close = shutdown

    def drain(self, deadline_s: float = 30.0) -> bool:
        """Graceful shutdown, phase one: new admissions are shed with a
        structured 429 + ``Retry-After`` while queued and in-flight work
        runs to completion (the dispatcher keeps feeding the engines).
        Returns True when the gateway went idle before the deadline —
        a ``shutdown()`` then drops nothing."""
        self._drain_retry_after_s = max(1.0, float(deadline_s))
        self._drain_ev.set()
        flight.record("gateway", "drain_begin",
                      deadline_s=float(deadline_s),
                      queued=self.scheduler.depth())
        deadline = time.perf_counter() + float(deadline_s)
        ok = False
        while time.perf_counter() < deadline:
            d = self.scheduler.depths()
            if all(v["queued"] == 0 and v["in_flight"] == 0
                   for v in d.values()):
                ok = True
                break
            time.sleep(0.01)
        flight.record("gateway", "drain_done", drained=ok)
        return ok

    @property
    def draining(self) -> bool:
        return self._drain_ev.is_set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    def _record_capture(self, creq: CompletionRequest, tenant: str,
                        priority: str, outcome: str, journey,
                        prompt=None):
        """One traffic-capture entry per admission outcome (admitted OR
        shed) — diagnostics, never control flow, so it must not raise
        into the handler.  ``prompt`` is the resolved token-id array
        when admission got that far; earlier exits hash the wire form."""
        ids = None
        text = None
        if prompt is not None:
            ids = prompt
        elif isinstance(creq.prompt, (list, tuple)):
            ids = creq.prompt
        else:
            text = creq.prompt
        try:
            self.capture.record(
                tenant=tenant, priority=priority, outcome=outcome,
                prompt=ids, text=text,
                prompt_len=len(text) if ids is None and text else None,
                max_tokens=creq.max_tokens, deadline_s=creq.deadline_s,
                temperature=creq.temperature, top_k=creq.top_k,
                seed=creq.seed, model=creq.model,
                conversation=getattr(creq, "conversation", None),
                journey_id=journey.id if journey is not None else "")
        except Exception:
            pass

    # -- admission (handler threads) -----------------------------------------
    def admit(self, creq: CompletionRequest, tenant: str,
              journey=None) -> GatewayRequest:
        """Validate fit, run the shed check, enqueue under the tenant's
        fair-share caps.  Raises ProtocolError (4xx), AdmissionError
        (429, incl. SLO shed) or GatewayClosedError (503).  ``journey``
        (a :mod:`~paddle_tpu_torch.observability.journey` Journey, usually
        minted by the HTTP handler from ``X-Request-Id``) rides the
        returned item through dispatch into the engine — every layer
        appends its phase records to it."""
        t_admit0 = time.perf_counter()
        if self._stop_ev.is_set():
            raise GatewayClosedError("gateway is shut down")
        if self._dispatcher_error is not None:
            raise GatewayClosedError(
                f"gateway dispatcher died: "
                f"{type(self._dispatcher_error).__name__}: "
                f"{self._dispatcher_error}")
        # tenant + priority class resolve BEFORE any shed exit so every
        # shed is attributed to its key in the telemetry window (per-
        # class SLO attainment is uncomputable otherwise) and the
        # journey carries both even when the request never enqueues
        cfg = self.scheduler.tenant_config(tenant)
        priority = creq.priority or cfg.priority
        if journey is not None:
            journey.annotate(tenant=tenant, priority=priority)
        if self._drain_ev.is_set():
            self._count(tenant, "shed")
            self.window.observe_shed("draining", tenant=tenant,
                                     priority=priority)
            registry().counter(GATEWAY_SHED, "requests shed by reason").inc(
                1.0, labels={"tenant": tenant, "reason": "draining"})
            self._record_capture(creq, tenant, priority, "draining", journey)
            raise AdmissionError(
                "draining", "gateway is draining for shutdown; retry "
                "against another replica",
                retry_after_s=self._drain_retry_after_s, tenant=tenant)
        if not self.router.any_alive() and not self._fleet_pending():
            self._record_capture(creq, tenant, priority, "no_engine", journey)
            raise NoEngineAvailableError(
                "no alive engine replica to serve this request")
        prompt = self._prompt_ids(creq)
        self.eos_for(creq)               # reject a bad stop field up front
        max_len = self.router.min_max_len()
        if prompt.size + creq.max_tokens > max_len:
            raise ProtocolError(
                400, f"prompt ({prompt.size}) + max_tokens "
                f"({creq.max_tokens}) exceeds the serving window "
                f"({max_len})", param="max_tokens", code="context_window")
        item = GatewayRequest(creq, tenant, priority, prompt,
                              adapter=self._resolve_adapter(creq),
                              journey=journey)
        if journey is not None:
            journey.annotate(completion_id=item.id,
                             prompt_tokens=int(prompt.size),
                             max_tokens=creq.max_tokens)
            if getattr(creq, "conversation", None):
                journey.annotate(conversation=creq.conversation)

        backlog = self.scheduler.backlog_cost(priority) + item.cost
        slots = self.router.total_slots()
        decision = self.shedder.decide(creq.deadline_s, backlog, slots)
        reg = registry()
        if decision.est_ttft_s is not None:
            reg.gauge(GATEWAY_TTFT_EST,
                      "estimated TTFT for a request joining now").set(
                decision.est_ttft_s)
        if not decision.admit:
            # scale-aware Retry-After: while a scale-up is building, the
            # static `est - deadline` horizon is wrong — capacity arrives
            # at warm-up completion (cold-build EWMA), so shed clients
            # should return exactly then, not later
            eta = self._scale_eta_s()
            if eta is not None and eta < decision.retry_after_s:
                decision.retry_after_s = max(0.1, round(eta, 2))
            self._count(tenant, "shed")
            self.window.observe_shed("slo_shed", tenant=tenant,
                                     priority=priority)
            reg.counter(GATEWAY_SHED, "requests shed by reason").inc(
                1.0, labels={"tenant": tenant, "reason": "slo_shed"})
            flight.record("gateway", "shed", request=item.id, tenant=tenant,
                          journey=journey.id if journey is not None else "",
                          est_ttft_ms=round(decision.est_ttft_s * 1e3, 1),
                          deadline_ms=round(creq.deadline_s * 1e3, 1),
                          backlog_tokens=round(backlog, 1))
            self._record_capture(creq, tenant, priority, "slo_shed",
                                 journey, prompt=prompt)
            raise AdmissionError(
                "slo_shed", decision.reason,
                retry_after_s=decision.retry_after_s, tenant=tenant,
                est_ttft_s=decision.est_ttft_s)
        try:
            self.scheduler.enqueue(item)
        except AdmissionError as e:
            self._count(tenant, "rejected")
            self.window.observe_shed(e.reason, tenant=tenant,
                                     priority=priority)
            reg.counter(GATEWAY_SHED, "requests shed by reason").inc(
                1.0, labels={"tenant": tenant, "reason": e.reason})
            flight.record("gateway", "shed", request=item.id, tenant=tenant,
                          reason=e.reason)
            self._record_capture(creq, tenant, priority, e.reason,
                                 journey, prompt=prompt)
            raise
        now = time.perf_counter()
        item.t_queue0 = now             # fair-share queue wait starts here
        if journey is not None:
            journey.phase("admit", t_admit0, now - t_admit0,
                          backlog_tokens=round(backlog, 1))
        self._count(tenant, "accepted")
        self._record_capture(creq, tenant, priority, "admitted",
                             journey, prompt=prompt)
        self._depth_gauges()
        flight.record("gateway", "admit", request=item.id, tenant=tenant,
                      priority=priority, prompt_len=int(prompt.size),
                      max_tokens=creq.max_tokens)
        return item

    def _resolve_adapter(self, creq: CompletionRequest) -> str | None:
        """``model=`` → LoRA adapter name through the registry.  Absent
        or the base model's name → None (adapter id 0); unknown names
        are a structured 404, a rank the bank can never hold is a 400 —
        both BEFORE the request queues."""
        name = creq.model
        if not name or name == self.model_name:
            return None
        reg = self.adapter_registry
        if reg is None or name not in reg:
            raise ProtocolError(
                404, f"model {name!r} is not served here (base model "
                f"{self.model_name!r}"
                + (f", adapters: {reg.names()}" if reg is not None else "")
                + ")", param="model", code="model_not_found")
        if reg.get(name).rank > reg.max_rank:
            raise ProtocolError(
                400, f"adapter {name!r} rank {reg.get(name).rank} exceeds "
                f"the serving bank width ({reg.max_rank})", param="model",
                code="adapter_rank")
        return name

    def _prompt_ids(self, creq: CompletionRequest) -> np.ndarray:
        prompt = creq.prompt
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ProtocolError(400, "string prompt needs a tokenizer",
                                    param="prompt", code="no_tokenizer")
            prompt = self.tokenizer.encode(prompt)
        ids = np.asarray(prompt, np.int64).reshape(-1)
        if ids.size < 1:
            raise ProtocolError(400, "'prompt' is empty", param="prompt",
                                code="empty_prompt")
        return ids

    def eos_for(self, creq: CompletionRequest):
        """Resolve the request's stop field to an eos token id."""
        stop = creq.stop
        if stop is None:
            return ...                   # engine default
        if isinstance(stop, str):
            if self.tokenizer is None:
                raise ProtocolError(400, "string 'stop' needs a tokenizer",
                                    param="stop", code="no_tokenizer")
            ids = self.tokenizer.encode(stop)
            ids = np.asarray(ids, np.int64).reshape(-1)
            if ids.size != 1:
                raise ProtocolError(
                    400, "'stop' must encode to a single token",
                    param="stop", code="invalid_stop")
            return int(ids[0])
        return int(stop)

    # -- result wait (handler threads) ---------------------------------------
    def result(self, item: GatewayRequest, timeout: float | None = None):
        """Block for the FINAL outcome (the reaper may transparently
        re-dispatch an engine death first); returns (token_ids, finish
        reason).  Failures re-raise for http.py to map."""
        if not item.done_ev.wait(timeout):
            raise TimeoutError(f"request {item.id} did not finish "
                               f"within {timeout}s")
        if item.final_error is not None:
            raise item.final_error
        tokens = item.handle.result(timeout=0)
        eos = item.handle.eos_token_id
        finish = ("stop" if eos is not None and tokens.size and
                  int(tokens[-1]) == eos else "length")
        return tokens, finish

    # -- dispatcher thread ---------------------------------------------------
    def _dispatch_loop(self):
        try:
            self._dispatch_impl()
        except Exception as e:  # noqa: BLE001 — die LOUDLY, not silently
            # dispatcher death must degrade /healthz and fail queued work
            # instead of hanging every admitted handler to its timeout.
            # single None->exc transition; admit()/healthz() read it
            # lock-free like the engine's _dead monitor flag
            self._dispatcher_error = e
            flight.record("gateway", "dispatcher_died",
                          error=f"{type(e).__name__}: {e}")
            err = GatewayClosedError(
                f"gateway dispatcher died: {type(e).__name__}: {e}")
            for item in self.scheduler.drain():
                item.fail(err)
                self._count(item.tenant, "failed")
            raise

    def _dispatch_impl(self):
        outstanding: list = []       # local to this thread — never shared
        while True:
            faults.fault_point("gateway.dispatch")
            self._reap(outstanding)
            if self._stop_ev.is_set():
                break
            if not self.router.has_headroom(self.dispatch_slack):
                if not self.router.any_alive() and \
                        not self._fleet_pending():
                    # every replica died with work queued: fail it loudly
                    # instead of letting handlers hang to their timeout
                    # (a DRAINING replica or an in-flight scale-up means
                    # capacity is coming — queued work waits instead)
                    item = self.scheduler.pop(timeout=0.02)
                    if item is not None:
                        self.scheduler.release(item.tenant, item.cost)
                        self._count(item.tenant, "failed")
                        item.fail(NoEngineAvailableError(
                            "every engine replica is dead"))
                    continue
                time.sleep(0.002)
                continue
            item = self.scheduler.pop(timeout=0.02)
            if item is None:
                continue
            if item.deadline is not None and \
                    time.perf_counter() > item.deadline:
                # expired while queued (shed model was cold or wrong):
                # fail it NOW, before it burns a slot
                self.scheduler.release(item.tenant, item.cost)
                self._count(item.tenant, "expired_queued")
                item.fail(AdmissionError(
                    "deadline_queued",
                    f"request {item.id} deadline passed while queued",
                    retry_after_s=0.5, tenant=item.tenant))
                self._depth_gauges()
                continue
            if not self._submit(item):
                continue
            outstanding.append(item)
            self._depth_gauges()
        # drain the reap list so tenants aren't left owing slots
        deadline = time.perf_counter() + 5.0
        while outstanding and time.perf_counter() < deadline:
            self._reap(outstanding)
            if outstanding:
                time.sleep(0.01)
        err = GatewayClosedError("gateway shut down mid-request")
        for item in outstanding:     # still running past the grace window
            self.scheduler.release(item.tenant, item.cost)
            self._count(item.tenant, "failed")
            item.finish(err)

    def _submit(self, item: GatewayRequest) -> bool:
        """Route one popped item to a replica.  True when submitted;
        False when it was requeued or failed (accounting settled)."""
        creq = item.creq
        t_pick0 = time.perf_counter()
        remaining = (None if item.deadline is None
                     else max(0.05, item.deadline - time.perf_counter()))
        tried: list = []
        while True:
            try:
                name, engine = self.router.pick(exclude=tried,
                                                adapter=item.adapter)
            except NoEngineAvailableError as e:
                if self._fleet_pending() or (tried and
                                             self.router.any_alive()):
                    # nothing pickable RIGHT NOW but a replica is
                    # draining out, a scale-up is building, or the
                    # replicas tried were full or restarting: park the
                    # item at the head of its queue — never redispatch
                    # onto a replica that is leaving, never 503 work
                    # that live or arriving capacity will absorb
                    self.scheduler.requeue(item)
                    time.sleep(0.002)
                    return False
                self.scheduler.release(item.tenant, item.cost)
                self._count(item.tenant, "failed")
                item.fail(e)
                return False
            try:
                handle = engine.submit(
                    item.prompt, max_new_tokens=creq.max_tokens,
                    eos_token_id=self.eos_for(creq),
                    temperature=creq.temperature, top_k=creq.top_k,
                    seed=creq.seed, deadline_s=remaining,
                    stream=self._stream_for(item), adapter=item.adapter,
                    journey=item.journey,
                    conversation=getattr(creq, "conversation", None))
            except QueueFullError:
                tried.append(name)
                if len(tried) >= len(self.router.names):
                    # every replica is briefly full: put the item back at
                    # the head of its tenant queue and let headroom gating
                    # retry — fair-share order is preserved
                    self.scheduler.requeue(item)
                    time.sleep(0.002)
                    return False
                continue
            except EngineDeadError:
                tried.append(name)
                flight.record("gateway", "failover", request=item.id,
                              engine=name)
                if len(tried) >= len(self.router.names):
                    if self.router.any_alive():
                        # a replica is mid-restart (supervised) or the
                        # death raced the pick: park the item back at the
                        # head of its queue and let the headroom gate
                        # retry once the fleet settles
                        self.scheduler.requeue(item)
                        time.sleep(0.002)
                        return False
                    self.scheduler.release(item.tenant, item.cost)
                    self._count(item.tenant, "failed")
                    item.fail(NoEngineAvailableError(
                        "every engine replica is dead"))
                    return False
                continue
            except Exception as e:  # noqa: BLE001 — surface to the caller
                self.scheduler.release(item.tenant, item.cost)
                self._count(item.tenant, "failed")
                item.fail(e)
                return False
            item.dispatched(handle, name)
            j = item.journey
            if j is not None:
                # queue = fair-share wait (enqueue/requeue -> this pop);
                # route = router pick + engine handoff.  t_queue0 resets
                # after each dispatch so a redispatch attributes only its
                # own wait.
                j.phase("queue", item.t_queue0, t_pick0 - item.t_queue0,
                        tenant=item.tenant)
                j.phase("route", t_pick0, item.t_dispatch - t_pick0,
                        engine=name)
                j.annotate(engine=name)
            item.t_queue0 = item.t_dispatch
            flight.record("gateway", "dispatch", request=item.id,
                          tenant=item.tenant, engine=name,
                          queue_wait_ms=round(
                              1e3 * (item.t_dispatch - item.t_enqueue), 2))
            return True

    def _stream_for(self, item: GatewayRequest):
        """The engine-side token callback: forwards into the item's
        token queue, and on the FIRST token feeds the shedder's prefill
        EWMA — at the prefill-completion journey boundary, not at handle
        reap.  (Reap-time feeding left ``est_ttft`` stale for the whole
        lifetime of long-running requests: a burst of them could blow
        every deadline before the model learned a thing.)"""
        t_sub = time.perf_counter()     # races dispatched(): close enough

        def _stream(tok, _item=item, _t_sub=t_sub):
            if _item.t_first_token is None:
                _item.t_first_token = time.perf_counter()
                self.shedder.observe_prefill(
                    _item.t_first_token - (_item.t_dispatch or _t_sub))
            _item.token_q.put(tok)
        return _stream

    def _reap(self, outstanding: list):
        """Retire finished engine handles: release the tenant's
        concurrency unit, feed the shedder, record per-tenant TTFT —
        and re-dispatch handles whose engine died before any token
        reached the client (bounded by ``max_redispatch``)."""
        done = [it for it in outstanding if it.handle.done()]
        if not done:
            return
        reg = registry()
        for item in done:
            outstanding.remove(item)
            err = item.handle.exception(timeout=0)
            if err is not None and self._redispatchable(item, err):
                item.redispatches += 1
                self._flush_tokens(item)
                item.t_first_token = None   # zero tokens reached the client
                from_engine = item.engine_name or ""
                self._note_outcome(from_engine, ok=False)
                t_r0 = time.perf_counter()
                reg.counter(
                    SERVING_REDISPATCHED,
                    "requests re-dispatched after an engine death").inc(
                    1.0, labels={"layer": "gateway"})
                flight.record("gateway", "redispatch", request=item.id,
                              attempt=item.redispatches,
                              from_engine=from_engine,
                              error=type(err).__name__)
                if item.journey is not None:
                    # the cross-replica hop, on the SAME journey id: the
                    # phases before it came from from_engine, the ones
                    # after from the survivor replica
                    item.journey.phase(
                        "redispatch", t_r0, time.perf_counter() - t_r0,
                        attempt=item.redispatches, from_engine=from_engine,
                        error=type(err).__name__)
                item.t_queue0 = time.perf_counter()
                if self._submit(item):
                    # new handle on another replica; tenant accounting is
                    # still owed — the item stays in flight
                    outstanding.append(item)
                # on False the item was either requeued (the main loop
                # pops and re-submits it) or permanently failed — both
                # settle the accounting inside _submit
                continue
            self.scheduler.release(item.tenant, item.cost)
            if err is None:
                self._count(item.tenant, "completed")
                # token latencies only: the prefill EWMA was already fed
                # at prefill completion (first streamed token), so a
                # burst of long decodes can no longer starve est_ttft
                self.shedder.observe_tokens(
                    item.handle.token_latencies_s)
                gw_ttft = None
                if item.handle.ttft_s is not None:
                    gw_ttft = (item.t_dispatch - item.t_enqueue) + \
                        item.handle.ttft_s
                    reg.histogram(
                        GATEWAY_TTFT,
                        "enqueue -> first token, per tenant").observe(
                        gw_ttft, labels={"tenant": item.tenant})
                self._note_outcome(item.engine_name, ok=True,
                                   ttft_s=gw_ttft)
                item.finish(None)
            else:
                # engine-side failure after dispatch (deadline inside the
                # engine, cancellation, unrecoverable engine death): the
                # reaper makes it final; handlers see it via result()
                outcome = type(err).__name__
                self._count(item.tenant, "expired_engine"
                            if "Deadline" in outcome else "failed")
                self._note_outcome(item.engine_name, ok=False)
                item.finish(err)
        self._depth_gauges()

    def _note_outcome(self, engine, ok: bool, ttft_s=None):
        """Feed the rollout controller's per-engine canary window (the
        reaper is the only place outcomes carry an engine name) —
        diagnostics, never control flow, so it must not raise into the
        dispatcher."""
        ctl = self.rollout
        if ctl is not None and engine:
            try:
                ctl.note_outcome(engine, ok, ttft_s)
            except Exception:  # noqa: BLE001 — a hook, not the data path
                pass

    def _redispatchable(self, item: GatewayRequest,
                        err: BaseException) -> bool:
        """The retry-safety rule: re-dispatch iff no token can have
        reached the client.  ``EngineDeadError`` means zero tokens were
        emitted at all; ``RequestInterruptedError`` means tokens were
        emitted but — for a NON-streaming request — they only ever
        reached the gateway's internal queue, which is flushed before
        the retry."""
        if item.redispatches >= self.max_redispatch:
            return False
        if self._stop_ev.is_set():
            return False
        if isinstance(err, EngineDeadError):
            return not item.handle.tokens    # engine guarantees zero
        if isinstance(err, RequestInterruptedError):
            return not item.creq.stream
        return False

    @staticmethod
    def _flush_tokens(item: GatewayRequest):
        while not item.token_q.empty():
            try:
                item.token_q.get_nowait()
            except queue.Empty:              # pragma: no cover - racing reap
                break

    # -- metrics helpers -----------------------------------------------------
    def _count(self, tenant: str, outcome: str):
        registry().counter(GATEWAY_REQUESTS,
                           "gateway requests by tenant and outcome").inc(
            1.0, labels={"tenant": tenant, "outcome": outcome})

    def _depth_gauges(self):
        reg = registry()
        for tenant, d in self.scheduler.depths().items():
            reg.gauge(GATEWAY_QUEUE_DEPTH,
                      "queued requests per tenant").set(
                float(d["queued"]), labels={"tenant": tenant})
            reg.gauge(GATEWAY_INFLIGHT,
                      "dispatched, unfinished requests per tenant").set(
                float(d["in_flight"]), labels={"tenant": tenant})

    # -- journeys / windowed feed --------------------------------------------
    def finish_journey(self, item: GatewayRequest, outcome: str = "ok"):
        """Close the item's journey (the HTTP handler calls this once
        the response — including the streamed tail — is on the wire, so
        the timeline covers the full client-observed window) and fold it
        into the rolling :class:`TelemetryWindow`."""
        j = item.journey
        if j is None:
            return
        handle = item.handle
        if handle is not None:
            j.annotate(tokens=len(handle.tokens),
                       redispatches=item.redispatches)
        j.finish(outcome)
        self.window.observe_journey(j)

    def window_stats(self) -> dict:
        """The trailing-window telemetry feed (queue-wait/TTFT/per-token
        p50+p99, shed rate, per-phase time shares, redispatch + rebuild
        counts) plus instantaneous load (queue depth, TTFT estimate) —
        the exact closed-loop input a trace-driven autoscaler consumes.
        Also refreshes the ``paddle_tpu_gateway_window_*`` gauges, so a
        ``/metrics`` scrape exports what this returns."""
        snap = self.window.snapshot()
        snap["queue_depth"] = self.scheduler.depth()
        shed_snap = self.shedder.snapshot()
        snap["est_ttft_s"] = self.shedder.estimate_ttft(
            self.scheduler.backlog_cost("batch"),
            self.router.total_slots())
        snap["shedder_observations"] = shed_snap["observations"]
        reg = registry()
        for key in ("ttft_s", "queue_wait_s", "token_s"):
            for q in ("p50", "p99"):
                reg.gauge(f"paddle_tpu_gateway_window_{key[:-2]}_seconds",
                          f"windowed {key[:-2]} percentiles").set(
                    snap[key][q], labels={"q": q})
        reg.gauge("paddle_tpu_gateway_window_shed_rate",
                  "shed fraction over the trailing window").set(
            snap["shed_rate"])
        reg.gauge("paddle_tpu_gateway_window_requests",
                  "journeys finished in the trailing window").set(
            float(snap["requests"]))
        reg.gauge("paddle_tpu_gateway_window_redispatches",
                  "redispatch phases in the trailing window").set(
            float(snap["redispatches"]))
        reg.gauge("paddle_tpu_gateway_window_rebuilds",
                  "supervisor rebuild phases in the trailing window").set(
            float(snap["rebuilds"]))
        for phase, share in snap["phase_share"].items():
            reg.gauge("paddle_tpu_gateway_window_phase_share",
                      "per-phase share of attributed request time").set(
                share, labels={"phase": phase})
        return snap

    # -- introspection -------------------------------------------------------
    def stats(self) -> dict:
        return {
            "tenants": self.scheduler.depths(),
            "engines": self.router.loads(),
            "shedder": self.shedder.snapshot(),
            "window": self.window.snapshot(),
            "closed": self._stop_ev.is_set(),
            "draining": self._drain_ev.is_set(),
            "dispatcher_alive": self.dispatcher_alive(),
        }

    def dispatcher_alive(self) -> bool:
        """False once the dispatcher thread died (or was never started):
        admitted work would hang, so /healthz degrades instead."""
        return (self._dispatcher_error is None and
                self._thread is not None and self._thread.is_alive())

    def healthz(self) -> dict:
        loads = self.router.loads()
        alive = [n for n, ld in loads.items() if ld["alive"]]
        dispatcher_ok = (self.dispatcher_alive() or
                         # not started yet (start=False tests): not dead
                         (self._thread is None and
                          self._dispatcher_error is None and
                          not self._stop_ev.is_set()))
        out = {
            "alive": (bool(alive) and not self._stop_ev.is_set() and
                      not self._drain_ev.is_set() and dispatcher_ok),
            "draining": self._drain_ev.is_set(),
            "dispatcher_alive": dispatcher_ok,
            "engines": {n: {"alive": ld["alive"],
                            "slots_in_use": ld["slots_in_use"],
                            "queue_depth": ld["queue_depth"],
                            "restarting": bool(ld.get("restarting"))}
                        for n, ld in loads.items()},
            "queued": self.scheduler.depth(),
            "priorities": sorted(PRIORITIES),
        }
        if self._dispatcher_error is not None:
            out["dispatcher_error"] = (
                f"{type(self._dispatcher_error).__name__}: "
                f"{self._dispatcher_error}")
        return out
