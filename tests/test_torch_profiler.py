"""The port's ``paddle.profiler`` against the JAX package's, on the CPU.

* ``make_scheduler``: the same state for every step over a grid of
  arguments, and the ``(start, end)`` tuple scheduler.
* The state machine: the same record windows (which spans each window
  holds, when ``on_trace_ready`` fires, the state after every step) for
  one-shot, repeating and ``stop()``-closed schedules; ``summary()`` lists
  each span once per recorded call.
* ``build_summary``: the same string for the same events and step times.
* The chrome export's four sources, as the JAX tests check them
  (``test_profiler_flags_distribution.py``, ``test_observability.py``'s
  chrome-trace tests, ``test_perfscope.py``'s device lane): host
  ``RecordEvent`` spans, ``observability.trace`` spans (``"cat":
  "span"``), perfscope's device intervals (``"cat": "device"``) and
  counter samples as ``"C"`` events with labels folded into the name.
* A GPU target without a card raises when the window would open (the
  JAX module swallows a failed device trace); ``timer_only`` traces no
  device and needs no card.
"""
import itertools
import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from paddle_tpu import profiler as jprof
from paddle_tpu.profiler import profiler_statistic as jstat

import paddle_tpu_torch as paddle
from _torch_cpu_place import cpu_place  # noqa: F401
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import profiler as pprof
from paddle_tpu_torch.observability import perfscope
from paddle_tpu_torch.observability import trace as obs_trace
from paddle_tpu_torch.profiler import profiler_statistic as pstat


@pytest.fixture(autouse=True)
def _telemetry_off():
    prev = obs.enabled()
    yield
    obs.enable(prev)


GRID = list(itertools.product([0, 1, 2], [0, 1], [1, 2, 3], [0, 1, 2],
                              [0, 2]))


@pytest.mark.parametrize("closed,ready,record,repeat,skip_first", GRID)
def test_make_scheduler_states_match_jax(closed, ready, record, repeat,
                                         skip_first):
    kw = dict(closed=closed, ready=ready, record=record, repeat=repeat,
              skip_first=skip_first)
    js, ps = jprof.make_scheduler(**kw), pprof.make_scheduler(**kw)
    assert [ps(i).name for i in range(24)] == [js(i).name for i in range(24)]


def test_make_scheduler_rejects_what_jax_rejects():
    for kw in (dict(closed=-1, ready=0, record=1),
               dict(closed=0, ready=-1, record=1),
               dict(closed=0, ready=0, record=0)):
        with pytest.raises(ValueError):
            jprof.make_scheduler(**kw)
        with pytest.raises(ValueError):
            pprof.make_scheduler(**kw)


def _drive(mod, scheduler, steps, stop_early=False):
    """``steps`` steps with one RecordEvent each; what each window held,
    the state after every step, and the summary's call counts."""
    windows = []
    p = mod.Profiler(targets=[mod.ProfilerTarget.CPU], scheduler=scheduler,
                     on_trace_ready=lambda prof: windows.append(
                         [e["name"] for e in prof._events]))
    states = [p.start().current_state.name]
    for i in range(steps):
        with mod.RecordEvent(f"op{i}"):
            with mod.RecordEvent("inner"):
                pass
        p.step()
        states.append(p.current_state.name)
        if stop_early and i == steps - 2:
            break
    p.stop()
    return windows, states, p.summary(), len(p._step_times)


@pytest.mark.parametrize("sched", [
    ("make", dict(closed=1, ready=1, record=2, repeat=2)),
    ("make", dict(closed=0, ready=0, record=2, repeat=0)),
    ("make", dict(closed=2, ready=0, record=3, repeat=1, skip_first=1)),
    ("tuple", (2, 5)), ("tuple", (0, 1)), ("none", None)],
    ids=["repeat2", "endless", "skip_first", "tuple_2_5", "tuple_0_1",
         "default"])
@pytest.mark.parametrize("stop_early", [False, True], ids=["run", "stop"])
def test_record_windows_match_jax(sched, stop_early):
    kind, arg = sched

    def make(mod):
        if kind == "make":
            return mod.make_scheduler(**arg)
        return arg

    jw, js, jsum, jn = _drive(jprof, make(jprof), 9, stop_early)
    pw, ps, psum, pn = _drive(pprof, make(pprof), 9, stop_early)
    assert pw == jw and ps == js and pn == jn
    assert jw, "no window recorded"
    # the summary lists each recorded call once: same names and counts
    rows = [ln.split()[:2] for ln in psum.splitlines()
            if ln[:1].isalnum() and not ln.startswith(("Name", "steps"))]
    jrows = [ln.split()[:2] for ln in jsum.splitlines()
             if ln[:1].isalnum() and not ln.startswith(("Name", "steps"))]
    assert sorted(rows) == sorted(jrows)


def test_build_summary_strings_match_jax():
    rs = np.random.RandomState(0)
    events = [{"name": f"op{i % 5}" + ("_with_a_rather_long_name" * (i % 2)),
               "ts": float(i), "dur": float(rs.uniform(1, 5000)), "tid": 1}
              for i in range(40)]
    steps = list(rs.uniform(0.001, 0.01, 7))
    for unit in ("s", "ms", "us"):
        assert pstat.build_summary(events, steps, unit) == \
            jstat.build_summary(events, steps, unit)
    assert pstat.build_summary([], [], "ms") == \
        jstat.build_summary([], [], "ms")
    assert [k.name for k in pstat.SortedKeys] == \
        [k.name for k in jstat.SortedKeys]


def test_step_info_and_export_round_trip(tmp_path):
    p = pprof.Profiler(scheduler=pprof.make_scheduler(
        closed=0, ready=0, record=2, repeat=1),
        on_trace_ready=pprof.export_chrome_tracing(str(tmp_path), "w0"),
        timer_only=True)
    p.start()
    for _ in range(3):
        with pprof.RecordEvent("my_op"):
            x = paddle.to_tensor(np.ones((8, 8), "float32"))
            (x @ x).numpy()
        p.step()
    p.stop()
    files = sorted(tmp_path.glob("w0_time_*.paddle_trace.json"))
    assert len(files) == 1
    data = pprof.load_profiler_result(str(files[0]))
    host = [e for e in data["traceEvents"] if e.get("cat") == "host"]
    assert [e["name"] for e in host] == ["my_op", "my_op"]
    assert data["displayTimeUnit"] == "ms"
    assert "my_op" in p.summary() and "steps: 3" in p.step_info()
    assert p.device_trace_path is None        # timer_only: no device trace


def test_chrome_export_merges_the_four_sources(tmp_path):
    obs.enable(True)
    with obs_trace.span("unit.outer"):
        pass
    perfscope.register_cost("perfscope.prof", "s", {"flops": 1.0})
    perfscope.record_sample("perfscope.prof", "s", 0.001)
    prof = pprof.Profiler(targets=[pprof.ProfilerTarget.CPU])
    prof.start()
    with pprof.RecordEvent("unit_span"):
        a = paddle.to_tensor(np.ones((2, 2), np.float32))
        (a + a).sum()
    prof.stop()
    path = str(tmp_path / "trace.json")
    prof.export(path)
    events = json.load(open(path))["traceEvents"]
    by_cat = {}
    for e in events:
        by_cat.setdefault(e.get("cat"), []).append(e)
    assert set(by_cat) == {"host", "span", "device", "telemetry"}
    assert [e["name"] for e in by_cat["host"]] == ["unit_span"]
    assert "unit.outer" in {e["name"] for e in by_cat["span"]}
    assert all(e["ph"] == "X" and "span_id" in e["args"]
               for e in by_cat["span"])
    dev = [e for e in by_cat["device"] if e["name"] == "perfscope.prof"]
    assert dev and all(e["ph"] == "X" and e["tid"] == "device:perfscope.prof"
                       for e in dev)
    counters = by_cat["telemetry"]
    assert all(e["ph"] == "C" and "value" in e["args"] for e in counters)
    assert any("op=" in e["name"] for e in counters)
    # the same merge, event for event, as the JAX module's helpers give
    # for the port's sources: nothing more, nothing less
    assert len(events) == 1 + len(obs_trace.chrome_events()) + len(
        perfscope.chrome_events()) + len(pprof.profiler.
                                         _telemetry_counter_events())


def test_record_event_spans_sit_on_the_span_clock():
    """Host spans and observability spans share the perf_counter base."""
    p = pprof.Profiler()
    p.start()
    with pprof.RecordEvent("clocked"):
        with obs_trace.span("unit.inner"):
            pass
    p.stop()
    host = p._events[0]
    inner = [e for e in obs_trace.chrome_events()
             if e["name"] == "unit.inner"][-1]
    assert host["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= host["ts"] + host["dur"] + 1.0


@pytest.mark.parametrize("target", ["GPU", "CUSTOM_DEVICE"])
def test_device_target_without_a_card_raises(monkeypatch, target):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = pprof.Profiler(targets=[pprof.ProfilerTarget.CPU,
                                getattr(pprof.ProfilerTarget, target)])
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        p.start()
    assert not pprof.profiler._TRACER.enabled
    # the same schedule with timer_only traces no device: it runs
    q = pprof.Profiler(targets=[pprof.ProfilerTarget.GPU], timer_only=True)
    q.start()
    with pprof.RecordEvent("t"):
        pass
    q.stop()
    assert [e["name"] for e in q._events] == ["t"]


def test_utils_and_top_level_export_the_profiler():
    from paddle_tpu_torch import utils

    assert utils.Profiler is pprof.Profiler
    assert paddle.profiler is pprof
    assert {n for n in dir(jprof) if not n.startswith("_")} - \
        set(dir(pprof)) <= {"annotations"}
