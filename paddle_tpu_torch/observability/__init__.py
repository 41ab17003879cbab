"""paddle_tpu_torch.observability — process-wide runtime telemetry.

The port's own copy of ``paddle_tpu/observability`` (it imports nothing
of the JAX package, and its registry is its own).  Two layers with
different duty cycles:

**Metrics (off by default).**  One registry (counters / gauges /
histograms with labels) fed by op-dispatch telemetry in the op hub
(``core/op.py`` ``apply_op`` through :mod:`dispatch`), the retrace
sentinel (:mod:`retrace`: the train step's and the serving engine's
signature books), step-level training metrics (:mod:`steps`: step
latency, examples/s, device memory gauges, the input pipeline; hapi
``TelemetryCallback``), and the serving engine, supervisor and gateway.
The one switch is the op layer's ``core.op.TELEMETRY``, as in the JAX
package: :func:`enable` sets it (and turns on the registry's time-series
samples and perfscope's exported series), and :func:`enabled` /
``TELEMETRY`` read it.  It costs one flag test per op when off.  Enable
with ``PADDLE_TPU_TELEMETRY=1`` or :func:`enable`.  Export with
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

from ..core import op as _op

_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide registry (always usable, even when disabled)."""
    return _REGISTRY


def enabled() -> bool:
    return _op.TELEMETRY


def __getattr__(name):
    # ``observability.TELEMETRY`` reads the op layer's switch
    if name == "TELEMETRY":
        return _op.TELEMETRY
    raise AttributeError(name)


def enable(on: bool = True):
    """Flip telemetry globally: the op layer's switch, the registry's
    samples and perfscope's series."""
    _op.TELEMETRY = bool(on)
    _REGISTRY.sampling = _op.TELEMETRY


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


# imported AFTER registry()/enable() exist: they pull `registry` from
# this package at import time
from . import dispatch  # noqa: E402,F401
from . import retrace  # noqa: E402,F401
from . import steps  # noqa: E402,F401
from .retrace import (  # noqa: E402,F401
    get_retrace_threshold, instrument_jit, set_retrace_threshold)
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
