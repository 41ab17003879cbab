"""Load shedding — telemetry-driven reject-early with Retry-After.

The engine already *measures* what an admission decision needs: every
finished request carries its TTFT and per-token decode latencies (the
series behind ``paddle_tpu_serving_ttft_seconds`` /
``_token_seconds``).  This module folds those observations into two EWMAs
and turns "queue depth" into "estimated time-to-first-token":

    est_ttft = prefill_ewma + token_ewma * backlog_tokens / total_slots

where ``backlog_tokens`` is the token-cost of work that would run before
the new request (queued at same-or-higher priority + all in-flight; see
``FairShareScheduler.backlog_cost``) and ``total_slots`` is the router's
aggregate decode parallelism — the pool retires ~``total_slots`` tokens
per decode step, so backlog drains at ``total_slots / token_ewma``
tokens/s.

A request carrying ``deadline_ms`` whose estimate blows the deadline is
rejected AT ADMISSION with a structured 429 + ``Retry-After`` — the
polite failure — instead of riding the queue just to deadline-expire
inside the engine after burning a slot (the rude one).  With no
observations yet (cold start) everything is admitted: the first requests
teach the model.
"""
from __future__ import annotations

import threading

__all__ = ["ShedDecision", "LoadShedder"]


class ShedDecision:
    __slots__ = ("admit", "est_ttft_s", "retry_after_s", "reason")

    def __init__(self, admit: bool, est_ttft_s: float | None,
                 retry_after_s: float = 0.0, reason: str = ""):
        self.admit = admit
        self.est_ttft_s = est_ttft_s
        self.retry_after_s = retry_after_s
        self.reason = reason


class LoadShedder:
    """EWMA latency model + the shed decision.  Thread-safe: handler
    threads call :meth:`decide`, the dispatcher calls :meth:`observe`."""

    def __init__(self, alpha: float = 0.2, *,
                 margin: float = 1.0):
        if not 0 < alpha <= 1:
            raise ValueError("alpha must be in (0, 1]")
        self._alpha = float(alpha)
        # margin scales the estimate before comparing to the deadline:
        # >1 sheds earlier (pessimistic), <1 later
        self.margin = float(margin)
        self._lock = threading.Lock()
        self._prefill_s: float | None = None
        self._token_s: float | None = None
        self._observations = 0

    # -- model updates -------------------------------------------------------
    def seed(self, prefill_s: float, token_s: float):
        """Prime the EWMAs (bench warmup / tests); later observations
        still blend in."""
        with self._lock:
            self._prefill_s = float(prefill_s)
            self._token_s = float(token_s)
            self._observations += 1

    def observe(self, ttft_s: float | None, token_latencies_s):
        """Fold one request's engine-side latency telemetry in.

        The two EWMAs have different natural feeding points, and feeding
        both at handle reap was a real bug: a burst of long-running
        requests finished nothing for their whole decode, so
        ``est_ttft`` ran on stale (or cold) numbers exactly when the
        shed decision mattered most.  The gateway therefore feeds the
        prefill EWMA at PREFILL COMPLETION (:meth:`observe_prefill`,
        fired when a request's first token streams — the journey phase
        boundary) and the token EWMA at reap
        (:meth:`observe_tokens`, when the per-token series is
        complete).  This combined form remains for tests/seeding."""
        toks = [t for t in (token_latencies_s or ()) if t > 0]
        with self._lock:
            a = self._alpha
            if ttft_s is not None and ttft_s > 0:
                self._prefill_s = (ttft_s if self._prefill_s is None else
                                   (1 - a) * self._prefill_s + a * ttft_s)
            if toks:
                mean = sum(toks) / len(toks)
                self._token_s = (mean if self._token_s is None else
                                 (1 - a) * self._token_s + a * mean)
            self._observations += 1

    def observe_prefill(self, ttft_s: float | None):
        """Feed the prefill EWMA the moment a request's first token
        exists — long-running requests update the model mid-flight
        instead of only at completion (the stale-estimate fix)."""
        self.observe(ttft_s, None)

    def observe_tokens(self, token_latencies_s):
        """Feed the token EWMA a finished request's per-token series."""
        self.observe(None, token_latencies_s)

    # -- estimates -----------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {"prefill_s": self._prefill_s, "token_s": self._token_s,
                    "observations": self._observations}

    def estimate_ttft(self, backlog_tokens: float,
                      total_slots: int) -> float | None:
        """Estimated TTFT for a request joining now; None while cold."""
        with self._lock:
            prefill, token = self._prefill_s, self._token_s
        if token is None:
            return None
        return (prefill or 0.0) + \
            token * float(backlog_tokens) / max(1, int(total_slots))

    def decide(self, deadline_s: float | None, backlog_tokens: float,
               total_slots: int) -> ShedDecision:
        """Admit unless the request names a deadline the estimate blows.
        Retry-After = how long until the backlog drains enough for the
        same request to fit its deadline."""
        est = self.estimate_ttft(backlog_tokens, total_slots)
        if deadline_s is None or est is None:
            return ShedDecision(True, est)
        if est * self.margin <= deadline_s:
            return ShedDecision(True, est)
        retry = max(0.1, round(est * self.margin - deadline_s, 2))
        return ShedDecision(
            False, est, retry_after_s=retry,
            reason=(f"estimated TTFT {est * 1e3:.0f}ms exceeds deadline "
                    f"{deadline_s * 1e3:.0f}ms "
                    f"(backlog {backlog_tokens:.0f} tokens over "
                    f"{total_slots} slots)"))
