"""paddle.profiler of the port (``paddle_tpu/profiler/profiler.py``
counterpart; reference python/paddle/profiler/profiler.py: Profiler:310,
ProfilerState:70, make_scheduler, export_chrome_tracing:195, and the
RecordEvent instrumentation of platform/profiler, host_tracer.cc).

The scheduler state machine (CLOSED -> READY -> RECORD[ ->
RECORD_AND_RETURN]), ``make_scheduler``, the ``(start, end)`` scheduler,
``step`` / ``step_info``, the summary and the chrome export are the JAX
module's.  Where the JAX package traces the device with ``jax.profiler``,
the port uses ``torch.profiler``:

* ``RecordEvent`` enters ``torch.profiler.record_function(name)`` (so the
  span names the region in a device trace) and books its host span on the
  ``perf_counter`` clock, as the JAX one enters ``TraceAnnotation``;
* for ``ProfilerTarget.GPU`` or ``CUSTOM_DEVICE`` (and not
  ``timer_only``), each record window runs under
  ``torch.profiler.profile(activities=[CPU, CUDA])``; when the window
  closes its chrome trace is written into a fresh temporary directory
  (``paddle_tpu_torch_prof_*``), whose file ``device_trace_path`` names
  (``device_trace_paths`` lists every window's);
* a device target that cannot be traced raises: without a card, or when
  ``torch.profiler`` fails to start, the record window does not open.
  The JAX module swallows a failed ``start_trace`` and carries on with
  host spans only; the port does not copy that.

The exported chrome JSON merges the same four sources as the JAX
module's: the host ``RecordEvent`` spans, ``observability.trace``'s
spans, ``perfscope``'s sampled device intervals and the registry's
counter samples as ``"C"`` events.  The device trace stays its own file.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from enum import Enum

import torch
from torch.profiler import ProfilerActivity, profile


class ProfilerState(Enum):
    """profiler.py:70."""
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    XPU = 2
    CUSTOM_DEVICE = 3


class _HostTracer:
    """RecordEvent span collector (host_tracer.cc analog)."""

    def __init__(self):
        self.events = []
        self.lock = threading.Lock()
        self.enabled = False

    def add(self, name, ts, dur, tid):
        if not self.enabled:
            return
        with self.lock:
            self.events.append({"name": name, "ts": ts, "dur": dur,
                                "tid": tid})


_TRACER = _HostTracer()


class RecordEvent:
    """paddle.profiler.RecordEvent parity: context manager / begin-end
    span."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._begin = None
        self._torch_ctx = None

    def begin(self):
        self._begin = time.perf_counter()
        self._torch_ctx = torch.profiler.record_function(self.name)
        self._torch_ctx.__enter__()

    def end(self):
        if self._begin is None:
            return
        dur = time.perf_counter() - self._begin
        _TRACER.add(self.name, self._begin * 1e6, dur * 1e6,
                    threading.get_ident())
        if self._torch_ctx is not None:
            self._torch_ctx.__exit__(None, None, None)
            self._torch_ctx = None
        self._begin = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0):
    """profiler.py make_scheduler parity: step -> ProfilerState."""
    if closed < 0 or ready < 0 or record <= 0:
        raise ValueError("closed/ready must be >=0 and record > 0")
    cycle = closed + ready + record

    def scheduler(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        step -= skip_first
        if repeat > 0 and step >= repeat * cycle:
            return ProfilerState.CLOSED
        pos = step % cycle
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == cycle - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return scheduler


def _default_state_scheduler(step: int):
    return ProfilerState.RECORD


def export_chrome_tracing(dir_name: str, worker_name: str | None = None):
    """profiler.py:195 parity: returns an on_trace_ready callback writing
    chrome-tracing json into dir_name."""
    os.makedirs(dir_name, exist_ok=True)

    def handler(prof):
        name = worker_name or f"host_{os.getpid()}"
        path = os.path.join(
            dir_name, f"{name}_time_{int(time.time() * 1000)}.paddle_trace.json")
        prof._export_chrome(path)
        return path

    return handler


def load_profiler_result(filename: str):
    with open(filename) as f:
        return json.load(f)


def _observability_span_events() -> list[dict]:
    """Completed observability spans as chrome 'X' events (``"cat":
    "span"``), on the host spans' perf_counter clock."""
    from ..observability import trace as obs_trace
    return obs_trace.chrome_events()


def _perfscope_device_events() -> list[dict]:
    """Sampled device-program intervals (perfscope ring) as chrome 'X'
    events (``"cat": "device"``)."""
    from ..observability import perfscope
    return perfscope.chrome_events()


def _telemetry_counter_events() -> list[dict]:
    """observability counter samples as chrome-trace 'C' events; label
    sets fold into the track name (``name{op=add,mode=eager}``)."""
    from .. import observability as obs
    samples = obs.registry().samples()
    if not samples:
        return []
    pid = os.getpid()
    events = []
    for s in samples:
        name = s["name"]
        if s["labels"]:
            inner = ",".join(f"{k}={v}" for k, v in sorted(
                s["labels"].items()))
            name = f"{name}{{{inner}}}"
        events.append({"name": name, "ph": "C", "ts": s["ts"], "pid": pid,
                       "cat": "telemetry", "args": {"value": s["value"]}})
    return events


class Profiler:
    """profiler.py:310 parity."""

    def __init__(self, *, targets=None, scheduler=None, on_trace_ready=None,
                 record_shapes=False, profile_memory=False, timer_only=False,
                 emit_nvtx=False, custom_device_types=None):
        self.targets = targets or [ProfilerTarget.CPU]
        if scheduler is None:
            self._scheduler = _default_state_scheduler
        elif isinstance(scheduler, (tuple, list)):
            start, end = scheduler
            self._scheduler = make_scheduler(
                closed=max(start, 0), ready=0, record=end - start, repeat=1)
        else:
            self._scheduler = scheduler
        self.on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        self.record_shapes = record_shapes
        self.profile_memory = profile_memory
        self.step_num = 0
        self.current_state = ProfilerState.CLOSED
        self._events = []
        self._step_times = []
        self._last_step_t = None
        self._torch_prof = None
        self._tmpdir = None
        self.device_trace_paths: list[str] = []

    @property
    def device_trace_path(self) -> str | None:
        """The chrome trace of the last closed device record window."""
        return self.device_trace_paths[-1] if self.device_trace_paths \
            else None

    # -- state machine -------------------------------------------------------
    def _transition(self, new_state: ProfilerState):
        recording = new_state in (ProfilerState.RECORD,
                                  ProfilerState.RECORD_AND_RETURN)
        if recording and not _TRACER.enabled:
            self._begin_record()
        elif not recording and _TRACER.enabled:
            self._end_record()
        self.current_state = new_state

    def _traces_device(self) -> bool:
        return not self.timer_only and (
            ProfilerTarget.CUSTOM_DEVICE in self.targets or
            ProfilerTarget.GPU in self.targets)

    def _begin_record(self):
        if self._traces_device():
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "paddle.profiler: a GPU target needs a CUDA card "
                    "(torch.cuda.is_available() is False); profile with "
                    "targets=[ProfilerTarget.CPU] or timer_only=True")
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA],
                           record_shapes=self.record_shapes,
                           profile_memory=self.profile_memory)
            prof.__enter__()
            self._torch_prof = prof
            self._tmpdir = tempfile.mkdtemp(prefix="paddle_tpu_torch_prof_")
        _TRACER.enabled = True
        _TRACER.events = []

    def _end_record(self):
        """Snapshot + clear the tracer and close the device window;
        callers fire on_trace_ready."""
        _TRACER.enabled = False
        self._events = list(_TRACER.events)
        _TRACER.events = []
        prof, self._torch_prof = self._torch_prof, None
        if prof is not None:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            path = os.path.join(self._tmpdir,
                                f"window_{len(self.device_trace_paths)}"
                                ".pt.trace.json")
            prof.export_chrome_trace(path)
            self.device_trace_paths.append(path)

    # -- public API ----------------------------------------------------------
    def start(self):
        self.step_num = 0
        self._last_step_t = time.perf_counter()
        self._transition(self._scheduler(0))
        return self

    def stop(self):
        if self.current_state in (ProfilerState.RECORD,
                                  ProfilerState.RECORD_AND_RETURN):
            self._end_record()
            if self.on_trace_ready:
                self.on_trace_ready(self)
        self.current_state = ProfilerState.CLOSED

    def step(self, num_samples=None):
        now = time.perf_counter()
        if self._last_step_t is not None:
            self._step_times.append(now - self._last_step_t)
        self._last_step_t = now

        prev = self.current_state
        self.step_num += 1
        new = self._scheduler(self.step_num)
        if prev == ProfilerState.RECORD_AND_RETURN or (
                prev == ProfilerState.RECORD and
                new in (ProfilerState.CLOSED, ProfilerState.READY)):
            # cycle boundary: close out this window (then _transition may
            # immediately open the next one, e.g. back-to-back repeats)
            self._end_record()
            if self.on_trace_ready:
                self.on_trace_ready(self)
        self._transition(new)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- export / summary ----------------------------------------------------
    def _export_chrome(self, path):
        events = [{"name": e["name"], "ph": "X", "ts": e["ts"],
                   "dur": e["dur"], "pid": os.getpid(), "tid": e["tid"],
                   "cat": "host"} for e in self._events]
        events += _observability_span_events()
        events += _perfscope_device_events()
        events += _telemetry_counter_events()
        with open(path, "w") as f:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, f)

    def export(self, path, format="json"):
        self._export_chrome(path)

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        from .profiler_statistic import build_summary
        return build_summary(self._events, self._step_times, time_unit)

    def step_info(self, unit=None):
        if not self._step_times:
            return "no steps recorded"
        import numpy as np
        arr = np.asarray(self._step_times)
        return (f"steps: {len(arr)}, avg: {arr.mean() * 1e3:.3f} ms, "
                f"min: {arr.min() * 1e3:.3f} ms, max: {arr.max() * 1e3:.3f} ms")
