"""The port's observability core against the JAX package's.

The registry (counters, gauges, histograms, label order, ``remove``,
``dump`` and the Prometheus text), the telemetry switch and its
``PADDLE_TPU_TELEMETRY`` bootstrap, spans with thread-local nesting, the
bounded flight ring, and the watchdog's bundle (arm / disarm, the
excepthook, extra sections): the same sequence of operations on both
packages gives the same text, records and bundle keys.  Each package keeps
a registry of its own.
"""
import json
import os
import subprocess
import sys
import threading
import time

import pytest

pytest.importorskip("jax")

from paddle_tpu import observability as jax_obs
from paddle_tpu.observability import flight as jax_flight
from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu.observability import trace as jax_trace
from paddle_tpu.observability import watchdog as jax_watchdog

from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.observability import flight, metrics, trace, watchdog
from paddle_tpu_torch.testing import faults


# -- the registry --------------------------------------------------------------

def _counters(reg):
    c = reg.counter("paddle_tpu_t_requests_total", "requests by outcome")
    c.inc(labels={"outcome": "ok", "tenant": "b"})
    c.inc(2.5, labels={"tenant": "a", "outcome": "ok"})
    c.inc(labels={"outcome": "shed"})
    c.inc()
    try:
        c.inc(-1.0)
    except ValueError as e:
        err = str(e)
    return [c.value({"outcome": "ok", "tenant": "b"}), c.total(), err]


def _gauges(reg):
    g = reg.gauge("paddle_tpu_t_depth", "queue depth")
    g.set(3, labels={"engine": "e1"})
    g.inc(2, labels={"engine": "e1"})
    g.dec(0.5, labels={"engine": "e1"})
    g.set(7, labels={"engine": "e2"})
    removed = [g.remove({"engine": "e2"}), g.remove({"engine": "zz"})]
    reg.gauge("paddle_tpu_t_plain").set(1.25)
    return [g.value({"engine": "e1"}), removed]


def _histograms(reg):
    h = reg.histogram("paddle_tpu_t_seconds", "latency")
    for v in (0.0004, 0.003, 0.2, 7.0, 500.0):
        h.observe(v, labels={"phase": "decode"})
    h.observe(0.01, labels={"phase": "prefill"})
    h2 = reg.histogram("paddle_tpu_t_custom", "", buckets=(1.0, 0.1, 10.0))
    h2.observe(0.5)
    return [h.snapshot({"phase": "decode"}), h.count({"phase": "prefill"}),
            h.total_count(), h2.snapshot(), h.snapshot({"phase": "none"})]


def _type_clash(reg):
    reg.counter("paddle_tpu_t_x")
    try:
        reg.gauge("paddle_tpu_t_x")
    except ValueError as e:
        return [str(e), reg.counter("paddle_tpu_t_x") is
                reg.get("paddle_tpu_t_x")]


def _everything(reg):
    return _counters(reg) + _gauges(reg) + _histograms(reg)


REGISTRY_CASES = [_counters, _gauges, _histograms, _type_clash, _everything]


@pytest.mark.parametrize("ops", REGISTRY_CASES,
                         ids=[f.__name__.strip("_") for f in REGISTRY_CASES])
def test_registry_text_and_dump_match_jax(ops):
    mine, theirs = metrics.MetricsRegistry(), jax_metrics.MetricsRegistry()
    assert ops(mine) == ops(theirs)
    assert mine.to_prometheus_text() == theirs.to_prometheus_text()
    assert mine.dump() == theirs.dump()
    assert mine.to_json() == theirs.to_json()
    mine.reset()
    assert mine.dump() == {"counters": {}, "gauges": {}, "histograms": {}}


def test_registry_is_the_ports_own_and_switch_samples():
    name = "paddle_tpu_t_own_total"
    obs.registry().counter(name).inc()
    try:
        assert jax_obs.registry().get(name) is None
        assert obs.registry() is not jax_obs.registry()
        was = obs.enabled()
        obs.enable(True)
        try:
            assert obs.enabled() and obs.TELEMETRY
            obs.registry().counter(name).inc(labels={"k": "v"})
            assert any(s["name"] == name and s["labels"] == {"k": "v"}
                       for s in obs.registry().samples())
            assert json.loads(obs.dump_json())["counters"][name]
            assert f"# TYPE {name} counter" in obs.to_prometheus_text()
        finally:
            obs.enable(was)
        obs.disable()
        assert not obs.enabled() and not obs.registry().sampling
    finally:
        obs.registry().reset()


@pytest.mark.parametrize("value,on", [("1", True), ("yes", True),
                                      ("0", False), ("", False)])
def test_telemetry_env_bootstrap(monkeypatch, value, on):
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY", value)
    try:
        obs._bootstrap_from_env()
        assert obs.enabled() is on
    finally:
        obs.disable()


# -- spans and the flight ring -------------------------------------------------

def _span_program(tr, fl):
    fl.clear()
    tr.clear()
    with tr.span("outer", engine="e0") as outer:
        outer.attrs["extra"] = 1
        with tr.span("inner", n=2):
            pass

        @tr.span("decorated", k="v")
        def fn():
            return tr.current_span().name
        inner_name = fn()
    try:
        with tr.span("failing"):
            raise KeyError("x")
    except KeyError:
        pass
    spans = tr.spans()
    by_id = {s["id"]: s["name"] for s in spans}
    shape = [(s["name"], by_id.get(s["parent_id"]), s["attrs"])
             for s in spans]
    events = [(e["kind"], e["name"],
               {k: v for k, v in e["attrs"].items()
                if k not in ("span_id", "parent_id", "dur_ms")})
              for e in fl.events()]
    return [inner_name, shape, events, tr.current_span(),
            [s["name"] for s in tr.spans("inner")],
            [e["ph"] for e in tr.chrome_events()]]


def test_spans_match_jax():
    assert _span_program(trace, flight) == \
        _span_program(jax_trace, jax_flight)


def test_open_spans_seen_from_another_thread():
    inside, release = threading.Event(), threading.Event()

    def worker():
        with trace.span("stuck", step=3):
            inside.set()
            release.wait(60)

    th = threading.Thread(target=worker)
    th.start()
    try:
        assert inside.wait(60)
        table = trace.open_spans()
        stacks = [st for st in table.values()
                  if st and st[-1]["name"] == "stuck"]
        assert stacks and stacks[0][-1]["attrs"] == {"step": 3}
        assert stacks[0][-1]["elapsed_s"] >= 0
    finally:
        release.set()
        th.join(60)
    assert not th.is_alive()


def _flight_program(fl):
    cap = fl.capacity()
    fl.clear()
    fl.set_capacity(8)
    try:
        for i in range(12):
            fl.record("serving" if i % 2 else "gateway", f"ev{i}", i=i,
                      kind="attr-named-kind")
        return [[(e["kind"], e["name"], e["attrs"]) for e in fl.events()],
                [e["name"] for e in fl.events("gateway")],
                [e["name"] for e in fl.tail(3)], fl.capacity(),
                fl.enabled()]
    finally:
        fl.set_capacity(cap)
        fl.clear()


def test_flight_ring_matches_jax():
    assert _flight_program(flight) == _flight_program(jax_flight)


def test_flight_disable_and_fault_events():
    flight.clear()
    flight.set_enabled(False)
    try:
        flight.record("x", "dropped")
        assert flight.events() == []
    finally:
        flight.set_enabled(True)
    faults.reset()
    try:
        with faults.inject("gateway.dispatch", times=1):
            with pytest.raises(faults.FaultInjected):
                faults.fault_point("gateway.dispatch", engine="e0", n=2,
                                   obj=object())
        ev = flight.events("fault")[-1]
        assert ev["name"] == "gateway.dispatch"
        assert ev["attrs"] == {"mode": "raise", "hit": 1, "engine": "e0",
                               "n": 2}
        assert faults.hits("gateway.dispatch") == 1
    finally:
        faults.reset()
        flight.clear()


# -- the watchdog --------------------------------------------------------------

def test_watchdog_bundle_keys_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DUMP_DIR", str(tmp_path))
    try:
        raise ValueError("boom")
    except ValueError:
        info = sys.exc_info()
    mine = watchdog.collect("unit", info)
    theirs = jax_watchdog.collect("unit", info)
    core = {"schema", "reason", "time", "pid", "argv", "flight_events",
            "open_spans", "threads", "exception"}
    assert core <= set(mine) and core <= set(theirs)
    assert mine["schema"] == theirs["schema"] == "paddle_tpu.crash_dump.v1"
    assert mine["exception"]["type"] == "ValueError"
    assert set(mine["exception"]) == set(theirs["exception"])
    assert "hbm_ledger" in mine            # perfscope's section
    path = watchdog.dump("unit/reason with spaces")
    assert path and os.path.dirname(path) == str(tmp_path)
    assert watchdog.last_dump_path() == path
    assert "unit_reason_with_spaces" in os.path.basename(path)
    with open(path) as fh:
        assert json.load(fh)["reason"] == "unit/reason with spaces"


def test_watchdog_sections_and_excepthook(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DUMP_DIR", str(tmp_path))

    def broken():
        raise RuntimeError("a section never blocks a dump")

    watchdog.add_section("unit_ok", lambda: {"x": 1})
    watchdog.add_section("unit_broken", broken)
    try:
        bundle = watchdog.collect("sections")
        assert bundle["unit_ok"] == {"x": 1} and "unit_broken" not in bundle
    finally:
        watchdog._sections.pop("unit_ok", None)
        watchdog._sections.pop("unit_broken", None)
    was = watchdog.installed()         # installed at import
    watchdog.uninstall()
    prev_hook = sys.excepthook
    try:
        watchdog.install()
        assert watchdog.installed()
        watchdog.install()                        # idempotent
        seen = []
        watchdog._prev_excepthook = lambda *a: seen.append(a[0])
        try:
            raise OSError("uncaught")
        except OSError:
            sys.excepthook(*sys.exc_info())
        assert seen == [OSError]
        assert "uncaught_exception" in watchdog.last_dump_path()
    finally:
        watchdog.uninstall()
        sys.excepthook = prev_hook
    assert not watchdog.installed()
    if was:
        watchdog.install()


def test_watchdog_arm_fires_once_and_disarm(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DUMP_DIR", str(tmp_path))
    monkeypatch.delenv("PADDLE_TPU_STEP_TIMEOUT_S", raising=False)
    assert watchdog.step_timeout() is None
    assert watchdog.arm("unit_step") is False
    fired0 = watchdog._watchdog.fired_count
    with trace.span("unit.stalled"):
        assert watchdog.arm("unit.stalled", 0.05)
        deadline = time.perf_counter() + 60
        while watchdog._watchdog.fired_count == fired0:
            assert time.perf_counter() < deadline
            time.sleep(0.01)
        time.sleep(0.2)
        watchdog.disarm()
    assert watchdog._watchdog.fired_count == fired0 + 1   # once an arm
    dumps = [f for f in os.listdir(tmp_path) if "unit.stalled" in f]
    assert dumps
    with open(os.path.join(tmp_path, dumps[0])) as fh:
        bundle = json.load(fh)
    assert bundle["reason"] == "step_timeout:unit.stalled"
    assert any(st and st[-1]["name"] == "unit.stalled"
               for st in bundle["open_spans"].values())
    monkeypatch.setenv("PADDLE_TPU_STEP_TIMEOUT_S", "30")
    assert watchdog.step_timeout() == 30.0
    assert watchdog.arm("unit.env")
    watchdog.disarm()


_SIGTERM_SCRIPT = r"""
import json, os, signal, sys, threading, time
import http.client

import torch

from paddle_tpu_torch.models import build_gpt
from paddle_tpu_torch.serving import Engine
from paddle_tpu_torch.serving.gateway import start_gateway

torch.set_num_threads(1)
torch.manual_seed(3)
model = build_gpt("gpt-tiny", device="cpu", max_position_embeddings=128)
eng = Engine(model, paged_kv=True, decode_kernel="pallas",
             sample_on_device=False, max_slots=2, max_len=48, page_size=8)
stack = start_gateway([eng], own_engines=True)
stack.install_sigterm_drain(deadline_s=120.0)
statuses, lock = [], threading.Lock()


def one(i):
    c = http.client.HTTPConnection("127.0.0.1", stack.port, timeout=300)
    try:
        c.request("POST", "/v1/completions",
                  json.dumps({"prompt": [i + 1, 2, 3],
                              "max_tokens": 6}).encode(),
                  {"Content-Type": "application/json"})
        r = c.getresponse()
        body = r.read()
        with lock:
            statuses.append((r.status,
                             len(json.loads(body)["choices"][0]["token_ids"])
                             if r.status == 200 else 0))
    finally:
        c.close()


one(40)
threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
for t in threads:
    t.start()
deadline = time.monotonic() + 120
while sum(d["enqueued"] for d in
          stack.gateway.scheduler.depths().values()) < 5:
    assert time.monotonic() < deadline, "the requests were never admitted"
    time.sleep(0.001)                    # all four admitted: in flight
os.kill(os.getpid(), signal.SIGTERM)
assert stack.wait_terminated(180), "drain did not finish"
for t in threads:
    t.join(timeout=60)
ok = len(statuses) == 5 and all(s == 200 and n == 6 for s, n in statuses)
print(json.dumps({"statuses": statuses, "drain_ok": bool(stack.drain_result)}))
sys.exit(0 if ok and stack.drain_result else 1)
"""


def test_gateway_sigterm_drains_and_exits_zero(tmp_path):
    """SIGTERM mid-load: the stack sheds new traffic, drains the queued
    and in-flight requests, closes, and the process exits 0 with none
    dropped (in a subprocess: the signal is the process's)."""
    script = tmp_path / "sigterm_drain.py"
    script.write_text(_SIGTERM_SCRIPT)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root,
               PADDLE_TPU_DUMP_DIR=str(tmp_path))
    proc = subprocess.run([sys.executable, str(script)], env=env,
                          capture_output=True, text=True, timeout=600,
                          cwd=root)
    assert proc.returncode == 0, (proc.stdout, proc.stderr[-3000:])
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["drain_ok"] is True
    assert all(s == 200 for s, _ in out["statuses"]), out


def test_registry_loses_no_update_under_thread_contention():
    """More threads than cores hammer one counter, gauge and histogram
    with a short switch interval: every update lands."""
    reg = metrics.MetricsRegistry()
    c = reg.counter("paddle_tpu_t_contended_total")
    g = reg.gauge("paddle_tpu_t_contended")
    h = reg.histogram("paddle_tpu_t_contended_seconds")
    n_threads, n = 4 * (os.cpu_count() or 1) + 4, 500
    go = threading.Event()

    def work(i):
        go.wait(60)
        for k in range(n):
            c.inc(labels={"w": i % 3})
            g.inc(1.0)
            h.observe(1e-3 * (k % 7))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        go.set()
        for th in threads:
            th.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert c.total() == g.value() == n_threads * n
    assert h.total_count() == n_threads * n
