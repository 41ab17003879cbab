"""paddle_tpu_torch.observability — process-wide runtime telemetry.

The port's own copy of ``paddle_tpu/observability`` for the serving path
(it imports nothing of the JAX package, and its registry is its own).
Two layers with different duty cycles:

**Metrics (off by default).**  One registry (counters / gauges /
histograms with labels) that the serving engine, the supervisor and the
gateway feed; the switch :func:`enable` also turns on the registry's
time-series samples and perfscope's exported series.  The JAX package
keeps this switch in its op layer (``core/op.py``'s ``TELEMETRY``); the
port has no op layer, so the switch lives here (:data:`TELEMETRY`).
Enable with ``PADDLE_TPU_TELEMETRY=1`` or :func:`enable`.  Export with
:func:`dump` (JSON) or :func:`to_prometheus_text`.

**Timeline (always on).**  :mod:`trace` spans (``span("serving.decode",
...)`` context manager/decorator with thread-local nesting), the
:mod:`flight` recorder (a bounded ring of structured events), and
:mod:`watchdog` crash/hang diagnostics (excepthook + SIGTERM/SIGINT dump
of the flight tail and all-thread stacks; an armed deadline around each
batched prefill / decode with ``Engine(decode_timeout_s=)``).  These run
from import because their cost is per-span, never per-op.

Request journeys (:mod:`journey`), the device perfscope (:mod:`perfscope`:
CUDA-event device timing of the decode graph's replays and the device
memory ledger), the SLO engine (:mod:`slo`: burn-rate alerts over the
journey window, incident bundles) and traffic capture (:mod:`capture`)
sit on top.
"""
from __future__ import annotations

import json
import os

from .metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry)

_REGISTRY = MetricsRegistry()
# the telemetry switch (the JAX package's ``core.op.TELEMETRY``)
TELEMETRY = False


def registry() -> MetricsRegistry:
    """The process-wide registry (always usable, even when disabled)."""
    return _REGISTRY


def enabled() -> bool:
    return TELEMETRY


def enable(on: bool = True):
    """Flip telemetry globally (registry samples and perfscope series)."""
    global TELEMETRY
    TELEMETRY = bool(on)
    _REGISTRY.sampling = TELEMETRY


def disable():
    enable(False)


def dump() -> dict:
    return _REGISTRY.dump()


def dump_json() -> str:
    return json.dumps(_REGISTRY.dump(), sort_keys=True)


def to_prometheus_text() -> str:
    return _REGISTRY.to_prometheus_text()


def _bootstrap_from_env():
    v = os.environ.get("PADDLE_TPU_TELEMETRY", "")
    if v.lower() in ("1", "true", "yes", "on"):
        enable(True)


# the always-on timeline layer (no registry dependency)
from . import flight  # noqa: E402,F401
from . import trace  # noqa: E402,F401
from . import watchdog  # noqa: E402,F401
from .trace import span  # noqa: E402,F401
# request journeys (per-request phase timelines + the windowed feed);
# imported after registry() exists: journey feeds phase histograms
from . import journey  # noqa: E402,F401
# device perfscope: sampled CUDA-event device time of the decode graph
# and the device memory ownership ledger
from . import perfscope  # noqa: E402,F401
# SLO engine: objectives + burn-rate alerts + incident bundles,
# layered over the keyed journey window and the watchdog seam
from . import slo  # noqa: E402,F401
# traffic capture: the always-on admission recorder + the trace fit
from . import capture  # noqa: E402,F401

_bootstrap_from_env()
watchdog._bootstrap_from_env()
