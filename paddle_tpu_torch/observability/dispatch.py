"""Op-dispatch telemetry: the counters behind ``@defop``.

The port's copy of ``paddle_tpu/observability/dispatch.py``.  Every op of
the paddle surface funnels through ``core.op.apply_op``; while telemetry
is on, that hub calls :func:`record` with the op name and its host
wall-time.  The JAX package splits "eager" from "traced" by
``jax.core.trace_state_clean()``; the port's counterpart of a trace is a
CUDA-graph capture on the current stream
(``torch.cuda.is_current_stream_capturing()``) or a ``torch.compile``
trace (``torch.compiler.is_compiling()``): inside either the op builds a
graph, outside it is an eager dispatch.  The port's train step is eager,
so its ops book as "eager".  Metric names and labels are the JAX
module's.
"""
from __future__ import annotations

import torch

from . import metrics as metrics_mod
from . import registry

# metric names (the JAX package's)
OP_DISPATCH_TOTAL = "paddle_tpu_op_dispatch_total"
OP_HOST_SECONDS = "paddle_tpu_op_host_seconds_total"


def _traced() -> bool:
    """True inside a CUDA-graph capture or a ``torch.compile`` trace."""
    if torch.compiler.is_compiling():
        return True
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def record(name: str, seconds: float):
    """One op dispatch: count it, split by mode, accumulate host time."""
    mode = "traced" if _traced() else "eager"
    reg = registry()
    reg.counter(OP_DISPATCH_TOTAL,
                "framework op dispatches through apply_op").inc(
        1.0, labels={"op": name, "mode": mode})
    reg.counter(OP_HOST_SECONDS,
                "cumulative host wall-time inside apply_op").inc(
        seconds, labels={"op": name})


def dispatch_counts(mode: str | None = None) -> dict[str, float]:
    """{op name: dispatch count}, optionally filtered by mode."""
    c = registry().get(OP_DISPATCH_TOTAL)
    out: dict[str, float] = {}
    if not isinstance(c, metrics_mod.Counter):
        return out
    for labels, v in c.series():
        if mode is not None and labels.get("mode") != mode:
            continue
        out[labels.get("op", "?")] = out.get(labels.get("op", "?"), 0.0) + v
    return out
