"""Retrace sentinel: catches signature-driven rebuild storms.

The port's copy of ``paddle_tpu/observability/retrace.py``.  ``jax.jit``
retraces and recompiles whenever a call arrives with a new abstract
signature; the port runs eagerly, but its entry points still build work
per signature: the train step's plan (``distributed/spmd.py``), the
serving engine's prefill buckets, tail prefills, page copies and decode
graph captures (``serving/engine.py``).  A stray Python int or a ragged
final batch turns each call into a new build there too, and a decode
signature that keeps changing recaptures its CUDA graph every step.  The
sentinel records every distinct abstract signature of an entry point and
its first call's wall-time, and logs ONE structured warning per
threshold crossing when the same entry point builds more than N times.

:class:`InstrumentedJit` is a pass-through wrapper over a callable keyed
by each call's abstract signature: the ``(shape, dtype)`` of every
tensor leaf of ``torch.utils._pytree``'s flattening of the arguments,
static leaves by ``repr``.  Entry points that keep their own signature
book (the engine's) report new signatures with :func:`note_compile`.
"""
from __future__ import annotations

import json
import logging
import os
import time

import torch
import torch.utils._pytree as pytree

from . import flight, perfscope, registry
from . import trace as trace_mod

logger = logging.getLogger("paddle_tpu.observability")

JIT_COMPILE_TOTAL = "paddle_tpu_jit_compile_total"
JIT_COMPILE_SECONDS = "paddle_tpu_jit_compile_seconds"
JIT_RETRACE_WARNINGS = "paddle_tpu_jit_retrace_warnings_total"
DYNAMIC_CACHE_WARNINGS = "paddle_tpu_dynamic_cache_warnings_total"

# warn when one entry point builds MORE than this many times
_DEFAULT_THRESHOLD = int(os.environ.get("PADDLE_TPU_RETRACE_WARN", "5"))
_threshold = [_DEFAULT_THRESHOLD]


def _telemetry() -> bool:
    from ..core import op as op_mod
    return op_mod.TELEMETRY


def set_retrace_threshold(n: int):
    _threshold[0] = int(n)


def get_retrace_threshold() -> int:
    return _threshold[0]


def _abstract_signature(args, kwargs=None) -> tuple:
    leaves, spec = pytree.tree_flatten((args, kwargs or {}))
    sig = []
    for lv in leaves:
        shape = getattr(lv, "shape", None)
        dtype = getattr(lv, "dtype", None)
        if shape is None and dtype is None:
            sig.append(repr(lv))  # static python leaf
        else:
            sig.append((tuple(shape) if shape is not None else None,
                        str(dtype)))
    return (str(spec), tuple(sig))


def record_compile(name: str, key, seconds: float, n_compiles: int):
    """Book one (re)build of entry point `name`; warn on storms."""
    reg = registry()
    reg.counter(JIT_COMPILE_TOTAL,
                "jit trace+compile events per entry point").inc(
        1.0, labels={"fn": name})
    reg.histogram(JIT_COMPILE_SECONDS,
                  "end-to-end compile wall-time (trace+lower+compile)"
                  ).observe(seconds, labels={"fn": name})
    if n_compiles > _threshold[0]:
        reg.counter(JIT_RETRACE_WARNINGS,
                    "retrace-storm warnings emitted").inc(
            1.0, labels={"fn": name})
        flight.record("retrace_storm", name, compiles=n_compiles,
                      threshold=_threshold[0])
        logger.warning(
            "paddle_tpu retrace sentinel: %s",
            json.dumps({"event": "retrace_storm", "fn": name,
                        "compiles": n_compiles,
                        "threshold": _threshold[0],
                        "last_signature": str(key)[:512],
                        "hint": "same step function keeps recompiling — "
                                "check for shape-polymorphic inputs "
                                "(ragged final batch, python scalars in "
                                "the data path)"}))


def note_compile(name: str, key, seconds: float, n_compiles: int):
    """An entry point with its own signature book saw signature ``key``
    for the first time (its ``n_compiles``-th): the flight event always,
    the metrics with telemetry on."""
    flight.record("compile", name, n_compiles=n_compiles,
                  seconds=round(float(seconds), 6),
                  signature=str(key)[:256])
    if _telemetry():
        record_compile(name, key, seconds, n_compiles)


_STATIC_CACHE_HINT = (
    "a growing-concat KV cache changes the key length every decode step, "
    "so a decode step rebuilds per token; use the STATIC cache path — "
    "caches of fixed-shape buffers, as built by "
    "paddle_tpu_torch.serving.Engine")
_dynamic_cache_warned: set = set()


def note_dynamic_cache_growth(site: str):
    """One-shot structured warning for the growing-concat KV-cache shape
    pattern: emitted the first time `site` is seen appending to a cache,
    into the flight recorder always and the metrics registry when telemetry
    is on.  The hint names the static-cache path to switch to."""
    if site in _dynamic_cache_warned:
        return
    _dynamic_cache_warned.add(site)
    flight.record("dynamic_kv_cache", site, hint=_STATIC_CACHE_HINT)
    logger.warning(
        "paddle_tpu retrace sentinel: %s",
        json.dumps({"event": "dynamic_kv_cache_growth", "site": site,
                    "hint": _STATIC_CACHE_HINT}))
    if _telemetry():
        registry().counter(
            DYNAMIC_CACHE_WARNINGS,
            "growing-concat KV-cache warnings emitted").inc(
            1.0, labels={"site": site})


def reset_dynamic_cache_warnings():
    """Re-arm the one-shot (tests)."""
    _dynamic_cache_warned.clear()


def _first_cuda(tree):
    for lv in pytree.tree_leaves(tree):
        if isinstance(lv, torch.Tensor) and lv.is_cuda:
            return lv.device
    return None


class InstrumentedJit:
    """Pass-through wrapper over a callable that books a build per
    distinct abstract signature.  Signature tracking is always on (one
    pytree flatten per *step* call, never per op) so build begin/end
    lands in the flight recorder even with telemetry off; the metrics
    registry is only touched when telemetry is on.  Attribute access
    delegates to the wrapped callable.

    Device perfscope rides the same wrapper: with
    ``PADDLE_TPU_PERFSCOPE_SAMPLE=N`` every Nth call of a known signature
    is bracketed by two CUDA events on the current stream and waits on
    the second (``perfscope.block_ready``) to book device seconds; the
    other ``N - 1`` calls record no event and wait for nothing.  On the
    CPU a sampled call is its host wall."""

    def __init__(self, fn, name: str):
        self._fn = fn
        self._name = name
        self._signatures: set = set()

    def _invoke(self, args, kwargs):
        try:
            return self._fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 — OOM forensics, then re-raise
            perfscope.note_exception(e, program=self._name)
            raise

    def _timed(self, key, args, kwargs):
        """One sampled call: its device time from CUDA events (its host
        wall on the CPU)."""
        dev = _first_cuda((args, kwargs))
        if dev is None:
            t0 = time.perf_counter()
            out = self._invoke(args, kwargs)
            perfscope.record_sample(self._name, key,
                                    time.perf_counter() - t0)
            return out
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self._invoke(args, kwargs)
        end.record()
        # audited sync: 1/N calls only (perfscope sampling)
        perfscope.block_ready(end)
        perfscope.record_sample(self._name, key,
                                start.elapsed_time(end) / 1e3)
        return out

    def __call__(self, *args, **kwargs):
        key = _abstract_signature(args, kwargs)
        sample = (perfscope.poll_sample(self._name)
                  if perfscope.sampling_active() else False)
        if key in self._signatures:
            if sample:
                return self._timed(key, args, kwargs)
            return self._invoke(args, kwargs)
        # a new abstract signature: the entry point builds its per-
        # signature state inside this call; the span books begin/end with
        # the key into the flight record.  Build calls are never timed.
        n = len(self._signatures) + 1
        t0 = time.perf_counter()
        with trace_mod.span("compile", fn=self._name, n_compiles=n,
                            signature=str(key)[:256]):
            out = self._invoke(args, kwargs)
        dt = time.perf_counter() - t0
        self._signatures.add(key)
        if _telemetry():
            record_compile(self._name, key, dt, len(self._signatures))
        return out

    def __getattr__(self, item):
        return getattr(self._fn, item)


def instrument_jit(fn, name: str) -> InstrumentedJit:
    return InstrumentedJit(fn, name)


def compile_count(name: str | None = None) -> float:
    """Total recorded builds (optionally for one entry point)."""
    c = registry().get(JIT_COMPILE_TOTAL)
    if c is None:
        return 0.0
    if name is None:
        return c.total()
    return c.value(labels={"fn": name})


def retrace_warning_count() -> float:
    c = registry().get(JIT_RETRACE_WARNINGS)
    return c.total() if c is not None else 0.0
