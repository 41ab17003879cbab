"""Bounded exponential-backoff retries for flaky remote IO (the port's
copy of ``paddle_tpu/utils/retry.py``).

Remote checkpoint storage (HDFS/GCS via the fleet ``fs`` clients) fails
transiently as a matter of course — the CheckFreq/Varuna posture is that a
blip must cost a retry, not a run.  :func:`retry_call` wraps one call in a
bounded exponential backoff: every retry emits a flight-recorder event
(``kind="retry"``) and, when a ``counter`` name is given, increments that
counter in the metrics registry (labelled by ``fn``), so retry pressure is
visible in the telemetry export before it becomes an outage.

The policy is deliberately bounded: ``tries`` total attempts, delays
``base_delay * factor**attempt`` capped at ``max_delay``.  The final
failure re-raises the original exception untouched.
"""
from __future__ import annotations

import functools
import time

__all__ = ["retry_call", "retryable"]


def retry_call(fn, *args, name: str, tries: int = 3,
               base_delay: float = 0.05, max_delay: float = 2.0,
               factor: float = 2.0, retry_on=(Exception,),
               counter: str | None = None, sleep=time.sleep, **kwargs):
    """Call ``fn(*args, **kwargs)`` with up to `tries` attempts."""
    if tries < 1:
        raise ValueError("tries must be >= 1")
    from ..observability import flight, registry
    for attempt in range(tries):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:  # noqa: PERF203 — retry loop, cold path
            if attempt + 1 >= tries:
                raise
            delay = min(max_delay, base_delay * (factor ** attempt))
            flight.record("retry", name, attempt=attempt + 1, tries=tries,
                          delay_s=round(delay, 4),
                          error=f"{type(e).__name__}: {e}"[:200])
            if counter:
                registry().counter(
                    counter, "retries of transient failures").inc(
                    1.0, labels={"fn": name})
            sleep(delay)


def retryable(name: str | None = None, **policy):
    """Decorator form: ``@retryable("fs.upload", tries=4)``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return retry_call(fn, *args, name=name or fn.__name__,
                              **policy, **kwargs)
        return wrapper
    return deco
