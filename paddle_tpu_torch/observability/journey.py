"""Request journeys — end-to-end per-request tracing with phase-level
latency attribution, plus the windowed telemetry feed built on top.

The port's copy of ``paddle_tpu/observability/journey.py``: the same
records give the same timeline dicts.

* a **Journey** is one request's bounded timeline.  The gateway handler
  mints one (or adopts the client's ``X-Request-Id``) and every layer
  the request crosses — protocol parse, fair-share queueing, router
  pick, engine queue, adapter load/stall, page stall, prefill,
  tail-prefill, prefix copy, each decode dispatch, stream emission,
  supervisor rebuild, cross-replica redispatch — appends a typed phase
  record (name, t_start, duration, attrs).
* the **attribution invariant**: when a journey finishes, its phases are
  laid out on one monotone timeline that PARTITIONS the observed wall
  time — overlapping records are clipped against a forward cursor, and
  every gap becomes an explicit ``unattributed`` phase.  By construction
  ``sum(phase durations) == wall time`` exactly, so a missing
  instrumentation site shows up as attributed-to-nothing instead of
  silently vanishing.
* **aggregates**: each finished journey feeds per-phase duration
  histograms (``paddle_tpu_journey_phase_seconds{phase,outcome}``), and
  a journey slower than the ``journey_slow_ms`` threshold dumps its full
  timeline to the flight recorder and a structured log line.
* **query surfaces**: finished journeys land in a bounded ring —
  ``GET /debug/requests/<id>`` returns one JSON timeline,
  ``GET /debug/requests?last=N`` the recent window, and
  :func:`chrome_events` renders them on the same clock base as
  ``trace.chrome_events``.
* :class:`TelemetryWindow` — a rolling time-windowed aggregator over
  finished journeys (queue-wait / TTFT / per-token p50/p99, shed rate,
  per-phase time shares, redispatch + rebuild counts).  The gateway
  exposes it as ``Gateway.window_stats()`` and under ``/metrics``.

Duty cycle: ring-buffered, always on, one host-side append per PHASE
(admission, one batched dispatch, a rebuild), never per token beyond the
existing dispatch boundary.  Nothing here touches the device: the decode
step's only host copy is its tokens, and a ``decode`` phase runs from the
step's launch to the end of that copy.
"""
from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
import uuid
from collections import deque

from . import flight, registry

__all__ = ["Journey", "TelemetryWindow", "begin", "adopt_or_begin", "get",
           "recent", "active", "set_slow_ms", "slow_ms", "chrome_events",
           "JOURNEY_PHASE_SECONDS", "UNATTRIBUTED"]

JOURNEY_PHASE_SECONDS = "paddle_tpu_journey_phase_seconds"

# the synthetic phase name gaps surface as (never recorded explicitly)
UNATTRIBUTED = "unattributed"

logger = logging.getLogger("paddle_tpu_torch.journey")

_lock = threading.Lock()
_seq = itertools.count(1)
# id -> live Journey (gateway handler owns begin/finish; layers append)
_active: dict[str, "Journey"] = {}
# finished journeys, oldest first — the /debug/requests?last=N window
_RING: deque = deque(
    maxlen=max(8, int(os.environ.get("PADDLE_TPU_JOURNEYS", "256"))))
# per-journey phase-record bound: decode dispatches are the only
# unbounded phase, so past the cap consecutive same-name records merge
# (the partition invariant survives; only per-dispatch granularity is
# lost on pathologically long generations)
_PHASE_CAP = max(16, int(os.environ.get("PADDLE_TPU_JOURNEY_PHASES", "512")))


def _slow_from_env() -> float | None:
    raw = os.environ.get("PADDLE_TPU_JOURNEY_SLOW_MS", "")
    try:
        v = float(raw)
    except ValueError:
        return None
    return v if v > 0 else None


_slow_ms: float | None = _slow_from_env()


def set_slow_ms(ms: float | None):
    """Set (or disable, with None) the slow-request threshold: a journey
    whose wall time reaches it dumps its full timeline to the flight
    recorder + a structured log line at finish."""
    global _slow_ms
    _slow_ms = None if ms is None or ms <= 0 else float(ms)


def slow_ms() -> float | None:
    return _slow_ms


class Journey:
    """One request's end-to-end timeline (see module docstring).

    Layers append with :meth:`phase`; the creator (the gateway handler,
    or whoever called :func:`begin`) calls :meth:`finish` exactly once.
    Thread-safe: phases arrive from handler, dispatcher and engine
    scheduler threads.
    """

    __slots__ = ("id", "t0", "t0_wall", "attrs", "_phases", "_t_first",
                 "_done", "_outcome", "_t_end", "_final", "_lock",
                 "_merged")

    def __init__(self, journey_id: str, **attrs):
        self.id = journey_id
        self.t0 = time.perf_counter()
        self.t0_wall = time.time()
        self.attrs = dict(attrs)
        self._phases: list[dict] = []   # raw records, append order
        self._t_first: float | None = None   # first generated token
        self._done = False
        self._outcome: str | None = None
        self._t_end: float | None = None
        self._final: list[dict] | None = None
        self._merged = 0
        self._lock = threading.Lock()

    # -- recording (any layer, any thread) -----------------------------------
    def phase(self, name: str, t_start: float, dur_s: float, **attrs):
        """Append one typed phase record.  ``t_start`` is a
        ``time.perf_counter()`` timestamp (the module clock), ``dur_s``
        its extent; attrs must be JSON-safe scalars.  Records may arrive
        out of order across threads — finalization sorts and clips."""
        rec = {"phase": str(name), "t": float(t_start),
               "dur": max(0.0, float(dur_s)), "attrs": attrs}
        with self._lock:
            if self._done:
                return          # late engine echo after finish: drop
            ph = self._phases
            if len(ph) >= _PHASE_CAP and ph and \
                    ph[-1]["phase"] == rec["phase"]:
                # bounded timeline: merge into the previous same-name
                # record (decode dispatches past the cap lose their
                # per-dispatch split, nothing else)
                last = ph[-1]
                last["dur"] = (rec["t"] + rec["dur"]) - last["t"]
                for k, v in attrs.items():
                    if isinstance(v, (int, float)) and \
                            isinstance(last["attrs"].get(k), (int, float)):
                        last["attrs"][k] += v
                    else:
                        last["attrs"][k] = v
                n = last["attrs"].get("merged", 1)
                last["attrs"]["merged"] = int(n) + 1
                self._merged += 1
                return
            ph.append(rec)

    def mark_first_token(self, t: float | None = None):
        """Record the first generated token's timestamp (once): the
        journey-level TTFT the window aggregator reports."""
        with self._lock:
            if self._t_first is None and not self._done:
                self._t_first = time.perf_counter() if t is None else t

    def annotate(self, **attrs):
        """Attach journey-level attrs (tenant, engine, token counts)."""
        with self._lock:
            self.attrs.update(attrs)

    # -- finalization (the creator, once) ------------------------------------
    def finish(self, outcome: str = "ok", t_end: float | None = None):
        """Close the journey: lay the raw records out as a monotone,
        gap-free partition of [t0, t_end] (gaps become ``unattributed``
        segments), feed the per-phase histograms, run the slow-request
        hook, and move the journey from the active table to the ring.
        Idempotent — the first call wins."""
        with self._lock:
            if self._done:
                return
            self._done = True
            self._outcome = str(outcome)
            self._t_end = (time.perf_counter() if t_end is None
                           else float(t_end))
            if self._t_end < self.t0:
                self._t_end = self.t0
            self._final = self._attribute_locked()
        with _lock:
            _active.pop(self.id, None)
            _RING.append(self)
        self._export()

    def _attribute_locked(self) -> list[dict]:
        """The attribution pass: sort raw records by start, clip each
        against a forward cursor from t0, insert ``unattributed``
        segments for gaps, close the tail at t_end.  The result is the
        invariant the tests assert: segment k+1 starts exactly where
        segment k ends, and the durations sum to the wall time."""
        t0, t_end = self.t0, self._t_end
        eps = 1e-6                  # sub-µs gaps are clock jitter, not time
        out: list[dict] = []
        cursor = t0
        for rec in sorted(self._phases, key=lambda r: r["t"]):
            start = max(rec["t"], cursor)
            end = min(max(rec["t"] + rec["dur"], start), t_end)
            if end <= cursor + eps:
                # fully shadowed by earlier attribution (overlapping
                # layers): keep the record's attrs on a zero segment so
                # nothing silently disappears from the JSON
                if rec["attrs"]:
                    out.append({"phase": rec["phase"], "t": cursor,
                                "dur": 0.0, "attrs": dict(rec["attrs"])})
                continue
            if start > cursor + eps:
                out.append({"phase": UNATTRIBUTED, "t": cursor,
                            "dur": start - cursor, "attrs": {}})
            else:
                start = cursor      # absorb jitter: stay gap-free
            out.append({"phase": rec["phase"], "t": start,
                        "dur": end - start, "attrs": dict(rec["attrs"])})
            cursor = end
        if t_end > cursor + eps:
            out.append({"phase": UNATTRIBUTED, "t": cursor,
                        "dur": t_end - cursor, "attrs": {}})
        elif out:
            # close the tail exactly at t_end (jitter absorbed into the
            # last segment) so the partition sums to the wall time
            out[-1]["dur"] += t_end - cursor
        return out

    def _export(self):
        hist = registry().histogram(
            JOURNEY_PHASE_SECONDS,
            "per-request journey phase durations")
        for seg in self._final:
            if seg["dur"] > 0:
                hist.observe(seg["dur"], labels={
                    "phase": seg["phase"], "outcome": self._outcome})
        thresh = _slow_ms
        wall_ms = (self._t_end - self.t0) * 1e3
        if thresh is not None and wall_ms >= thresh:
            tl = self.timeline()
            payload = json.dumps(tl["phases"])
            if len(payload) > 4096:
                payload = payload[:4096] + "...]"
            flight.record("journey", "slow", request=self.id,
                          outcome=self._outcome,
                          wall_ms=round(wall_ms, 3),
                          threshold_ms=float(thresh), phases=payload)
            logger.warning(
                "slow journey %s: %.1f ms (threshold %.1f ms) "
                "outcome=%s timeline=%s",
                self.id, wall_ms, thresh, self._outcome, payload)

    # -- introspection -------------------------------------------------------
    @property
    def done(self) -> bool:
        return self._done

    @property
    def outcome(self) -> str | None:
        return self._outcome

    @property
    def wall_s(self) -> float | None:
        return None if self._t_end is None else self._t_end - self.t0

    @property
    def ttft_s(self) -> float | None:
        """First generated token relative to journey start (None before
        a token exists)."""
        return None if self._t_first is None else self._t_first - self.t0

    def phases(self) -> list[dict]:
        """The finished, attributed partition (finished journeys) or a
        snapshot of the raw records (live ones)."""
        with self._lock:
            if self._final is not None:
                return [dict(p, attrs=dict(p["attrs"])) for p in self._final]
            return [dict(p, attrs=dict(p["attrs"])) for p in self._phases]

    def phase_totals(self) -> dict[str, float]:
        """{phase name: total attributed seconds} of a finished journey."""
        out: dict[str, float] = {}
        for seg in self.phases():
            out[seg["phase"]] = out.get(seg["phase"], 0.0) + seg["dur"]
        return out

    def timeline(self) -> dict:
        """The JSON shape /debug/requests serves: phase offsets are
        milliseconds relative to the journey start; ``mono0`` is the
        process-monotonic base (perf_counter seconds) so external tools
        can merge with the span ring's chrome events."""
        with self._lock:
            done, outcome, t_end = self._done, self._outcome, self._t_end
            t_first = self._t_first
            merged = self._merged
        return {
            "id": self.id,
            "done": done,
            "outcome": outcome,
            "t_start_unix": self.t0_wall,
            "mono0": self.t0,
            "wall_ms": (None if t_end is None
                        else round((t_end - self.t0) * 1e3, 3)),
            "ttft_ms": (None if t_first is None
                        else round((t_first - self.t0) * 1e3, 3)),
            "attrs": dict(self.attrs),
            "merged_phase_records": merged,
            "phases": [{"phase": p["phase"],
                        "t_ms": round((p["t"] - self.t0) * 1e3, 3),
                        "dur_ms": round(p["dur"] * 1e3, 3),
                        "attrs": p["attrs"]} for p in self.phases()],
        }

    def __repr__(self):
        return (f"Journey(id={self.id!r}, phases={len(self._phases)}, "
                f"done={self._done}, outcome={self._outcome})")


# -- registry ------------------------------------------------------------------

def _mint_id() -> str:
    return f"req-{uuid.uuid4().hex[:16]}"


def begin(journey_id: str | None = None, **attrs) -> Journey:
    """Start a journey; ``journey_id=None`` mints one.  An id already
    active gets a uniquifying suffix (a client reusing X-Request-Id must
    not cross-wire two live timelines)."""
    jid = _sanitize(journey_id) or _mint_id()
    with _lock:
        if jid in _active:
            jid = f"{jid}-{next(_seq)}"
        j = Journey(jid, **attrs)
        _active[jid] = j
    return j


def adopt_or_begin(header_value: str | None, **attrs) -> Journey:
    """The gateway entry point: adopt the client's ``X-Request-Id`` when
    present (so client-side and server-side traces correlate), mint
    otherwise."""
    return begin(header_value, **attrs)


def _sanitize(raw: str | None) -> str | None:
    if raw is None:
        return None
    s = "".join(c for c in str(raw).strip() if c.isprintable())[:128]
    return s or None


def get(journey_id: str) -> Journey | None:
    """Look one journey up by id — live ones first, then the ring."""
    with _lock:
        j = _active.get(journey_id)
        if j is not None:
            return j
        for j in reversed(_RING):
            if j.id == journey_id:
                return j
    return None


def recent(n: int = 32) -> list[Journey]:
    """The newest finished journeys, oldest first."""
    with _lock:
        out = list(_RING)
    return out[-max(0, int(n)):]


def active() -> list[Journey]:
    """Live (unfinished) journeys."""
    with _lock:
        return list(_active.values())


def clear():
    """Drop every finished journey and forget live ones (tests)."""
    with _lock:
        _RING.clear()
        _active.clear()


def chrome_events(journeys=None) -> list[dict]:
    """Finished journeys as chrome-trace 'X' events on the SAME clock
    base as trace.chrome_events (perf_counter * 1e6), ``"cat":
    "journey"`` — drop them into the profiler's chrome JSON next to the
    span and counter tracks and each request renders as one row of
    phase blocks."""
    pid = os.getpid()
    out = []
    for j in (recent(len(_RING) or 1) if journeys is None else journeys):
        for seg in j.phases():
            args = dict(seg["attrs"])
            args["journey"] = j.id
            out.append({"name": seg["phase"], "ph": "X",
                        "ts": seg["t"] * 1e6, "dur": seg["dur"] * 1e6,
                        "pid": pid, "tid": j.id, "cat": "journey",
                        "args": args})
    return out


# -- the windowed feed ---------------------------------------------------------

def _percentile(sorted_vals: list[float], q: float) -> float:
    """Linear-interpolated percentile over a pre-sorted list."""
    if not sorted_vals:
        return 0.0
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


class TelemetryWindow:
    """Rolling time-windowed aggregate over finished journeys — the
    closed-loop feed a trace-driven autoscaler consumes: queue-wait /
    TTFT / per-token p50+p99, shed rate, per-phase time shares,
    redispatch + rebuild counts, all over the trailing ``window_s``
    seconds.

    Samples are **keyed** by ``(tenant, priority class)``: each key owns
    its own bounded deque, so a noisy tenant flooding the window can only
    evict its OWN oldest samples, never another tenant's — per-class SLO
    attainment stays computable under skewed load.  :meth:`snapshot`
    aggregates globally or per key with ``by="tenant"`` / ``by="class"``;
    :meth:`events` hands the raw in-horizon samples+sheds to an SLO
    burn-rate evaluator.

    Feed it with :meth:`observe_journey` (one call per finished
    journey), :meth:`observe_shed` (one call per shed/rejected
    admission), or the low-level :meth:`observe_sample` (a
    virtual-time feed).  Bounded: at most ``max_samples_per_key``
    samples per key, at most ``max_keys`` keys (least-recently-fed key
    evicted first), oldest-in-key dropped first.
    """

    # phases whose attributed time counts as "waiting in a queue" for
    # the queue_wait percentile (gateway fair-share + engine admission)
    QUEUE_PHASES = ("queue", "engine_queue", "adapter_stall", "page_stall")

    def __init__(self, window_s: float = 60.0, max_samples: int = 4096,
                 *, max_samples_per_key: int | None = None,
                 max_keys: int = 64):
        if window_s <= 0:
            raise ValueError("window_s must be > 0")
        self.window_s = float(window_s)
        self.max_samples = max(16, int(max_samples))
        # per-key bound: a key never holds more than this, so the
        # worst-case retention is max_keys * max_samples_per_key
        self.max_samples_per_key = (
            max(16, self.max_samples // 8) if max_samples_per_key is None
            else max(16, int(max_samples_per_key)))
        self.max_keys = max(1, int(max_keys))
        self._lock = threading.Lock()
        # (tenant, priority) -> deque; separate stores for samples and
        # sheds, one LRU clock across both for key eviction
        self._samples: dict[tuple, deque] = {}
        self._sheds: dict[tuple, deque] = {}
        self._touched: dict[tuple, float] = {}

    @staticmethod
    def _key(tenant, priority) -> tuple:
        return (str(tenant or ""), str(priority or ""))

    def _deque_for_locked(self, store: dict, key: tuple,
                          now: float) -> deque:
        dq = store.get(key)
        if dq is None:
            dq = store[key] = deque(maxlen=self.max_samples_per_key)
        self._touched[key] = now
        known = set(self._samples) | set(self._sheds)
        while len(known) > self.max_keys:
            victim = min(known - {key},
                         key=lambda k: self._touched.get(k, 0.0))
            self._samples.pop(victim, None)
            self._sheds.pop(victim, None)
            self._touched.pop(victim, None)
            known.discard(victim)
        return dq

    # -- feeding -------------------------------------------------------------
    def observe_journey(self, j: Journey, now: float | None = None, *,
                        tenant: str | None = None,
                        priority: str | None = None):
        """Fold one FINISHED journey in (unfinished ones are skipped:
        their partition does not exist yet).  Tenant and priority class
        default to the journey's own attrs (the gateway annotates both
        at admission)."""
        if j is None or not j.done:
            return
        totals = j.phase_totals()
        queue_wait = sum(totals.get(p, 0.0) for p in self.QUEUE_PHASES)
        decode_s = totals.get("decode", 0.0)
        tokens = 0
        redispatches = 0
        rebuilds = 0
        for seg in j.phases():
            name = seg["phase"]
            if name == "decode":
                tokens += int(seg["attrs"].get("emitted", 0) or 0)
            elif name == "redispatch":
                redispatches += 1
            elif name == "rebuild":
                rebuilds += 1
        self.observe_sample(
            now=now,
            wall_s=j.wall_s or 0.0,
            ttft_s=j.ttft_s,
            queue_wait_s=queue_wait,
            # decode emits the first-of-run token too, but the FIRST
            # token of the request came from prefill — per-token decode
            # latency divides decode time by the decode-emitted count
            token_s=(decode_s / tokens) if tokens > 0 else None,
            phase_totals=totals,
            outcome=j.outcome or "ok",
            redispatches=redispatches,
            rebuilds=rebuilds,
            tenant=tenant if tenant is not None else j.attrs.get("tenant"),
            priority=(priority if priority is not None
                      else j.attrs.get("priority")))

    def observe_sample(self, *, now: float | None = None,
                       wall_s: float = 0.0, ttft_s: float | None = None,
                       queue_wait_s: float | None = None,
                       token_s: float | None = None,
                       phase_totals: dict | None = None,
                       outcome: str = "ok", redispatches: int = 0,
                       rebuilds: int = 0, tenant: str | None = None,
                       priority: str | None = None):
        """Low-level feed: one finished-request sample without a Journey
        object — how a simulator drives the window (and an SLO
        evaluator on top of it) in virtual time."""
        t = time.perf_counter() if now is None else float(now)
        tenant, priority = self._key(tenant, priority)
        sample = {
            "t": t, "wall_s": float(wall_s),
            "ttft_s": None if ttft_s is None else float(ttft_s),
            "queue_wait_s": (None if queue_wait_s is None
                             else float(queue_wait_s)),
            "token_s": None if token_s is None else float(token_s),
            "phase_totals": dict(phase_totals or {}),
            "outcome": str(outcome),
            "redispatches": int(redispatches),
            "rebuilds": int(rebuilds),
            "tenant": tenant, "priority": priority,
        }
        with self._lock:
            self._deque_for_locked(
                self._samples, (tenant, priority), t).append(sample)

    def observe_shed(self, reason: str = "", now: float | None = None, *,
                     tenant: str | None = None,
                     priority: str | None = None):
        """One shed/rejected admission, attributed to its tenant and
        priority class (per-tenant shed rates stay computable)."""
        t = time.perf_counter() if now is None else float(now)
        tenant, priority = self._key(tenant, priority)
        shed = {"t": t, "reason": str(reason),
                "tenant": tenant, "priority": priority}
        with self._lock:
            self._deque_for_locked(
                self._sheds, (tenant, priority), t).append(shed)

    # -- reading -------------------------------------------------------------
    def _prune_locked(self, now: float):
        horizon = now - self.window_s
        for store in (self._samples, self._sheds):
            for key in list(store):
                dq = store[key]
                while dq and dq[0]["t"] < horizon:
                    dq.popleft()
                if not dq:
                    del store[key]
        for key in list(self._touched):
            if key not in self._samples and key not in self._sheds:
                del self._touched[key]

    def _collect_locked(self, now: float, horizon_s: float | None,
                        tenant: str | None, priority: str | None):
        lo = now - min(self.window_s, horizon_s if horizon_s is not None
                       else self.window_s)
        out = []
        for store in (self._samples, self._sheds):
            rows = []
            for key, dq in store.items():
                if tenant is not None and key[0] != str(tenant):
                    continue
                if priority is not None and key[1] != str(priority):
                    continue
                rows.extend(r for r in dq if lo <= r["t"] <= now)
            out.append(rows)
        return out[0], out[1]

    def events(self, now: float | None = None, *,
               horizon_s: float | None = None, tenant: str | None = None,
               priority: str | None = None) -> tuple:
        """``(samples, sheds)`` inside the trailing ``horizon_s``
        (clamped to ``window_s``), optionally filtered to one tenant
        and/or priority class — the raw feed the SLO burn-rate
        evaluator counts good/bad events over."""
        now = time.perf_counter() if now is None else float(now)
        with self._lock:
            self._prune_locked(now)
            samples, sheds = self._collect_locked(
                now, horizon_s, tenant, priority)
        return ([dict(s) for s in samples], [dict(s) for s in sheds])

    def keys(self, now: float | None = None) -> list:
        """The ``(tenant, priority)`` keys with in-window data."""
        now = time.perf_counter() if now is None else float(now)
        with self._lock:
            self._prune_locked(now)
            return sorted(set(self._samples) | set(self._sheds))

    @staticmethod
    def _aggregate(samples: list, sheds: list) -> dict:
        def _pcts(key):
            vals = sorted(s[key] for s in samples if s[key] is not None)
            return {"p50": round(_percentile(vals, 0.50), 6),
                    "p99": round(_percentile(vals, 0.99), 6),
                    "n": len(vals)}

        phase_totals: dict[str, float] = {}
        for s in samples:
            for name, dur in s["phase_totals"].items():
                phase_totals[name] = phase_totals.get(name, 0.0) + dur
        attributed = sum(phase_totals.values())
        shares = {name: round(dur / attributed, 4)
                  for name, dur in sorted(phase_totals.items())} \
            if attributed > 0 else {}
        n_requests = len(samples)
        n_shed = len(sheds)
        denominator = n_requests + n_shed
        return {
            "requests": n_requests,
            "shed": n_shed,
            "shed_rate": round(n_shed / denominator, 4) if denominator
            else 0.0,
            "shed_reasons": _count_by(sheds, "reason"),
            "ttft_s": _pcts("ttft_s"),
            "queue_wait_s": _pcts("queue_wait_s"),
            "token_s": _pcts("token_s"),
            "phase_share": shares,
            "redispatches": sum(s["redispatches"] for s in samples),
            "rebuilds": sum(s["rebuilds"] for s in samples),
            "outcomes": _count_by(samples, "outcome"),
        }

    def snapshot(self, now: float | None = None,
                 by: str | None = None) -> dict:
        """The window aggregate, computed fresh (sorting a few thousand
        floats at poll rate, not request rate).  ``by=None`` is the
        global aggregate; ``by="tenant"`` / ``by="class"`` group by the
        sample key's tenant / priority-class component — the per-key
        feed SLO objectives with a ``per=`` selector evaluate over."""
        if by not in (None, "tenant", "class"):
            raise ValueError('by must be None, "tenant" or "class"')
        now = time.perf_counter() if now is None else float(now)
        with self._lock:
            self._prune_locked(now)
            samples, sheds = self._collect_locked(now, None, None, None)
        if by is None:
            out = {"window_s": self.window_s}
            out.update(self._aggregate(samples, sheds))
            return out
        field = "tenant" if by == "tenant" else "priority"
        groups: dict[str, tuple] = {}
        for s in samples:
            groups.setdefault(s[field], ([], []))[0].append(s)
        for s in sheds:
            groups.setdefault(s[field], ([], []))[1].append(s)
        return {
            "window_s": self.window_s,
            "by": by,
            "keys": {name: self._aggregate(ss, sh)
                     for name, (ss, sh) in sorted(groups.items())},
        }


def _count_by(samples, key) -> dict:
    out: dict[str, int] = {}
    for s in samples:
        out[s[key]] = out.get(s[key], 0) + 1
    return out
