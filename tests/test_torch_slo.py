"""The port's SLO engine against the JAX package's.

``paddle_tpu_torch.observability.slo`` is the port's copy of
``paddle_tpu/observability/slo.py``.  The pure layers are held to the JAX
package on the same inputs: the objective's validation, the multi-window
burn-rate evaluator's transitions (fast and slow rules, the min-events
gate, shed-rate and availability signals, pending -> firing -> resolved
hold-down, per-tenant expansion) from the same window samples at the same
virtual ``now``s, the ``scale_on_alerts`` policy seam, and ``FleetSim``
with an evaluator on the flash and steady traces (equal result dicts).
Then the port alone: the incident ring on disk, an incident bundle with
all three telemetry planes (its keys those of the JAX bundle), the
gateway's shed sites feeding the keyed window, and a live gateway on
gpt-tiny whose fast-burn alert fires, writes a bundle that
``tools/incident_report.py`` renders, and whose ``/debug/slo`` and
``/debug/incidents`` payloads carry the JAX package's keys.  The keyed
window itself is held to the JAX package in ``test_torch_journey.py``.
Every wait is bounded.
"""
import http.client
import json
import time

import pytest
import torch

pytest.importorskip("jax")

from paddle_tpu.observability import journey as jax_journey
from paddle_tpu.observability import slo as jax_slo
from paddle_tpu.serving import FleetSim as JaxFleetSim
from paddle_tpu.serving import ScalePolicy as JaxScalePolicy
from paddle_tpu.serving.gateway import Gateway as JaxGateway
from paddle_tpu.serving.gateway import TenantConfig as JaxTenantConfig

from paddle_tpu_torch.models import build_gpt
from paddle_tpu_torch.observability import journey, slo
from paddle_tpu_torch.serving import Engine, FleetSim, ScalePolicy
from paddle_tpu_torch.serving.gateway import (AdmissionError, Gateway,
                                              TenantConfig,
                                              parse_completion_request,
                                              start_gateway)
from paddle_tpu_torch.testing.load_gen import make_trace

torch.set_num_threads(1)

TIMEOUT = 120
PORT = dict(slo=slo, window=journey.TelemetryWindow, policy=ScalePolicy,
            sim=FleetSim)
JAX = dict(slo=jax_slo, window=jax_journey.TelemetryWindow,
           policy=JaxScalePolicy, sim=JaxFleetSim)


def _close(a, b, tol=1e-12):
    """Equal structures, floats to ``tol``."""
    if isinstance(a, float) or isinstance(b, float):
        return (a is None) == (b is None) and abs(a - b) <= tol
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_close(a[k], b[k], tol) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_close(x, y, tol) for x, y in zip(a, b)))
    return a == b


def _both(scenario):
    """Run ``scenario`` over each package; the results must agree."""
    got, want = scenario(PORT), scenario(JAX)
    assert _close(got, want), (got, want)
    return got


def _obj(m, **kw):
    base = dict(signal="ttft_p99", target=0.9, threshold_s=1.0,
                fast_window_s=5.0, fast_burn=8.0, slow_window_s=50.0,
                slow_burn=2.0, fire_ticks=2, resolve_ticks=3,
                min_events=4)
    base.update(kw)
    return m["slo"].SloObjective(kw.pop("name", "obj"), base.pop("signal"),
                                 base.pop("target"), **base)


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _post(port, payload, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        hdrs = {"Content-Type": "application/json"}
        hdrs.update(headers or {})
        conn.request("POST", "/v1/completions",
                     json.dumps(payload).encode(), hdrs)
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(7)
    return build_gpt("gpt-tiny", device="cpu", max_position_embeddings=128)


# -- objective validation -----------------------------------------------------

BAD_OBJECTIVES = [
    ("o", "nope", 0.9, {}),
    ("o", "shed_rate", 1.0, {}),                       # no error budget
    ("o", "ttft_p99", 0.9, {}),                        # missing threshold
    ("o", "shed_rate", 0.9, {"per": "tenant", "tenant": "a"}),
    ("o", "shed_rate", 0.9, {"fast_window_s": 60.0, "slow_window_s": 10.0}),
    ("", "shed_rate", 0.9, {}),
    ("o", "shed_rate", 0.9, {"per": "engine"}),
    ("o", "shed_rate", 0.9, {"fast_burn": 0.0}),
]


def test_objective_validation():
    ok = slo.SloObjective("o", "ttft_p99", 0.9, threshold_s=1.0)
    want = jax_slo.SloObjective("o", "ttft_p99", 0.9, threshold_s=1.0)
    assert ok.snapshot() == want.snapshot()
    assert ok.snapshot()["signal"] == "ttft_p99"
    for name, signal, target, kw in BAD_OBJECTIVES:
        errors = []
        for mod in (slo, jax_slo):
            with pytest.raises(ValueError) as e:
                mod.SloObjective(name, signal, target, **kw)
            errors.append(str(e.value))
        assert errors[0] == errors[1]
    with pytest.raises(ValueError):
        slo.SloEvaluator([])
    with pytest.raises(ValueError):
        slo.SloEvaluator([ok, slo.SloObjective("o", "shed_rate", 0.9)])


# -- the burn-rate matrix, both packages --------------------------------------

def test_burn_fast_rule_catches_flash():
    """A dense burst of bad events trips the FAST rule within a few
    seconds of the flash's start."""
    def run(m):
        tw = m["window"](window_s=100.0)
        ev = m["slo"].SloEvaluator([_obj(m)])
        t, trs = 0.0, []
        for _ in range(50):                           # healthy baseline
            t += 1.0
            tw.observe_sample(now=t, ttft_s=0.1)
            trs += ev.tick(tw, now=t)
        for _ in range(10):                           # flash: all bad
            t += 1.0
            for _ in range(3):
                tw.observe_sample(now=t, ttft_s=5.0)
            trs += ev.tick(tw, now=t)
        return trs, ev.firing(), ev.state()

    trs, firing, _ = _both(run)
    fired = [tr for tr in trs if tr["to"] == "firing"]
    assert fired and fired[0]["rule"] == "fast" and fired[0]["t"] <= 57.0
    assert firing and firing[0]["rule"] == "fast"


def test_burn_slow_rule_catches_leak():
    """~25% bad (burn 2.5x) never trips the fast rule at 8x but trips the
    slow one."""
    def run(m):
        tw = m["window"](window_s=100.0)
        ev = m["slo"].SloEvaluator([_obj(m)])
        t, trs = 0.0, []
        for i in range(60):
            t += 1.0
            tw.observe_sample(now=t, ttft_s=5.0 if i % 4 == 0 else 0.1)
            trs += ev.tick(tw, now=t)
        return trs, ev.state()

    trs, _ = _both(run)
    rules = [tr["rule"] for tr in trs if tr["to"] == "firing"]
    assert rules and set(rules) == {"slow"}


def test_burn_under_budget_is_silent():
    """5% bad against a 90% target is burn 0.5: no alert ever."""
    def run(m):
        tw = m["window"](window_s=100.0)
        ev = m["slo"].SloEvaluator([_obj(m)])
        t, trs = 0.0, []
        for i in range(100):
            t += 1.0
            tw.observe_sample(now=t, ttft_s=5.0 if i % 20 == 10 else 0.1)
            trs += ev.tick(tw, now=t)
        return trs, ev.state()

    trs, state = _both(run)
    assert trs == [] and state[0]["state"] == "inactive"


def test_burn_min_events_gates_thin_traffic():
    """One bad sample (burn 10x) stays silent below ``min_events``."""
    def run(m):
        tw = m["window"](window_s=100.0)
        ev = m["slo"].SloEvaluator([_obj(m, min_events=4)])
        tw.observe_sample(now=1.0, ttft_s=5.0)
        first = ev.tick(tw, now=1.0)
        for t in (2.0, 3.0, 4.0):
            tw.observe_sample(now=t, ttft_s=5.0)
        return first, ev.tick(tw, now=4.0) + ev.tick(tw, now=5.0)

    first, later = _both(run)
    assert first == []
    assert any(tr["to"] == "firing" for tr in later)


def test_shed_rate_and_availability_signals():
    def run(m):
        tw = m["window"](window_s=100.0)
        kw = dict(fast_window_s=5.0, fast_burn=5.0, slow_window_s=50.0,
                  fire_ticks=1, min_events=4)
        ev = m["slo"].SloEvaluator([
            m["slo"].SloObjective("sheds", "shed_rate", 0.9, **kw),
            m["slo"].SloObjective("avail", "availability", 0.9, **kw)])
        t, trs = 0.0, []
        for _ in range(8):
            t += 1.0
            tw.observe_shed("slo_shed", now=t)
            tw.observe_sample(now=t, outcome="engine_error")
            trs += ev.tick(tw, now=t)
        return trs, ev.state()

    trs, _ = _both(run)
    assert {tr["objective"] for tr in trs if tr["to"] == "firing"} == {
        "sheds", "avail"}


def test_alert_lifecycle_holddown_and_resolve():
    """A one-tick blip enters pending and clears without firing; a
    sustained breach fires only after ``fire_ticks``; recovery resolves
    only after ``resolve_ticks`` clears."""
    def run(m):
        tw = m["window"](window_s=100.0)
        ev = m["slo"].SloEvaluator([_obj(m, fire_ticks=3, resolve_ticks=4)])
        clock = [0.0]

        def feed(bad, n=4):
            clock[0] += 1.0
            for _ in range(n):
                tw.observe_sample(now=clock[0],
                                  ttft_s=5.0 if bad else 0.001)
            return ev.tick(tw, now=clock[0])

        blip = feed(bad=True)
        for _ in range(8):
            blip += feed(bad=False, n=40)
        after_blip = (ev.firing(), ev.state())
        breach = []
        for _ in range(10):
            breach += feed(bad=True)
        firing = ev.firing()
        recovery = []
        for _ in range(30):
            recovery += feed(bad=False, n=60)
            if any(tr["to"] == "resolved" for tr in recovery):
                break
        return blip, after_blip, breach, firing, recovery, ev.firing()

    blip, after_blip, breach, firing, recovery, end = _both(run)
    assert [tr["to"] for tr in blip] == ["pending", "inactive"]
    assert after_blip[0] == [] and after_blip[1][0]["state"] == "inactive"
    assert [tr["to"] for tr in breach] == ["pending", "firing"]
    assert firing and firing[0]["objective"] == "obj"
    assert recovery[-1]["to"] == "resolved" and end == []


def test_per_tenant_expansion():
    def run(m):
        tw = m["window"](window_s=100.0)
        ev = m["slo"].SloEvaluator([_obj(m, per="tenant", fire_ticks=1)])
        t, trs = 0.0, []
        for _ in range(8):
            t += 1.0
            for _ in range(4):
                tw.observe_sample(now=t, ttft_s=5.0, tenant="noisy")
                tw.observe_sample(now=t, ttft_s=0.1, tenant="calm")
            trs += ev.tick(tw, now=t)
        return trs, ev.state()

    trs, state = _both(run)
    assert {tr["key"] for tr in trs if tr["to"] == "firing"} == {"noisy"}
    states = {r["key"]: r["state"] for r in state}
    assert states == {"noisy": "firing", "calm": "inactive"}


# -- the autoscaler seam and the virtual-time fleet ---------------------------

def test_scale_policy_scale_on_alerts():
    def run(m):
        healthy = {"est_ttft_s": 0.1, "queue_wait_s": {"p99": 0.0, "n": 5},
                   "requests": 5, "shed": 0, "shed_rate": 0.0,
                   "queue_depth": 0, "slots_in_use": 0, "total_slots": 4,
                   "prefill_s": 0.05}
        alerting = dict(healthy, firing_alerts=[
            {"objective": "ttft", "key": "all", "rule": "fast",
             "since": 1.0}])
        pol = m["policy"](scale_on_alerts=True, up_ticks=1)
        return (m["policy"]().breach_reason(alerting),
                pol.breach_reason(dict(healthy, firing_alerts=[])),
                pol.breach_reason(alerting),
                pol.decide(alerting, replicas=1, min_replicas=1,
                           max_replicas=4, now=100.0),
                pol.snapshot())

    default, quiet, alert, decision, snap = _both(run)
    assert default == "" and quiet == "" and alert == "slo_alert"
    assert tuple(decision) == ("up", "slo_alert")
    assert snap["scale_on_alerts"] is True


def _sim_objective(m):
    return m["slo"].SloObjective(
        "sim-ttft", "ttft_p99", 0.9, threshold_s=1.55, fast_window_s=3.0,
        fast_burn=6.0, slow_window_s=15.0, slow_burn=2.0, fire_ticks=2,
        resolve_ticks=6, min_events=4)


def _sim_policy(m):
    return m["policy"](slo_ttft_s=1.55, headroom_frac=0.4, up_ticks=1,
                       idle_ticks=8, cooldown_up_s=4.0, cooldown_down_s=3.0)


@pytest.mark.parametrize("shape", ["flash", "steady"])
def test_fleetsim_slo_flash_fires_and_resolves(shape):
    """The flash trace fires the fast rule during the crowd and resolves
    after a scale-up; the steady trace fires nothing."""
    if shape == "flash":
        trace = make_trace(60.0, 20.0, seed=0, flash_mult=2.5, flash_at=0.25,
                           flash_duration_s=10.0, prompt_mean=12.0,
                           out_mean=10.0, out_max=48)
        start = 1
    else:
        trace = make_trace(60.0, 8.0, seed=1, flash_mult=1.0)
        start = 2

    def run(m):
        return m["sim"](
            _sim_policy(m), min_replicas=1, max_replicas=6,
            start_replicas=start, slots_per_replica=4, prefill_s=0.05,
            token_s=0.01, build_s=2.0, policy_poll_s=0.25, window_s=5.0,
            slo_evaluator=m["slo"].SloEvaluator([_sim_objective(m)])
        ).run(trace)

    res = _both(run)
    sim = res["slo"]
    if shape == "steady":
        assert sim["fired"] == 0
        return
    assert sim["fired"] >= 1 and sim["resolved"] == sim["fired"]
    firings = [tr for tr in sim["transitions"] if tr["to"] == "firing"]
    assert all(tr["rule"] == "fast" for tr in firings)
    first_up = min(e["t"] for e in res["events"] if e["direction"] == "up")
    assert min(tr["t"] for tr in sim["transitions"]
               if tr["to"] == "resolved") > first_up


# -- incident bundles ---------------------------------------------------------

def test_incident_store_roundtrip_and_ring(tmp_path):
    store = slo.IncidentStore(str(tmp_path), max_incidents=3)
    ids = [store.write({"schema": slo.INCIDENT_SCHEMA,
                        "incident": {"objective": f"obj{i}", "key": "all",
                                     "t": float(i)}})
           for i in range(5)]
    ring = store.list()
    assert [m["id"] for m in ring] == ids[-3:]
    assert len(list(tmp_path.glob("*.json"))) == 3
    assert not list(tmp_path.glob("*.tmp"))          # written atomically
    bundle = store.get(ids[-1])
    assert bundle["schema"] == slo.INCIDENT_SCHEMA == jax_slo.INCIDENT_SCHEMA
    assert bundle["incident"]["objective"] == "obj4"
    assert bundle["incident"]["id"] == ids[-1]
    assert store.get(ids[0]) is None and store.get("nope") is None
    jstore = jax_slo.IncidentStore(str(tmp_path / "jax"), max_incidents=3)
    jstore.write({"incident": {"objective": "o"}})
    assert set(ring[0]) == set(jstore.list()[0])


def test_build_incident_correlates_planes():
    def run(m):
        tw = m["window"](window_s=100.0)
        now = time.perf_counter()
        tw.observe_sample(now=now, ttft_s=2.0, tenant="acme",
                          priority="interactive")
        tw.observe_shed("slo_shed", now=now, tenant="acme")
        return m["slo"].build_incident(
            {"objective": "o", "key": "acme", "rule": "fast", "t": 2.0,
             "burn_fast": 9.0, "burn_slow": 2.0, "attainment": 0.7},
            window=tw)

    bundle, want = run(PORT), run(JAX)
    assert bundle["schema"] == slo.INCIDENT_SCHEMA
    assert bundle["incident"]["objective"] == "o"
    assert bundle["window"]["global"]["requests"] == 1
    assert "acme" in bundle["window"]["by_tenant"]["keys"]
    assert "interactive" in bundle["window"]["by_class"]["keys"]
    for key in ("flight_events", "threads", "perf", "memory",
                "slowest_journeys"):
        assert key in bundle
    assert set(bundle["incident"]) == set(want["incident"])
    assert set(bundle["window"]) == set(want["window"])
    assert set(bundle["perf"]) == set(want["perf"])
    json.dumps(bundle, default=str)


# -- the gateway --------------------------------------------------------------

def test_gateway_shed_sites_attribute_tenant(tiny):
    """Every gateway shed path records (tenant, priority) in the keyed
    window, and the journey carries both though the request never
    enqueues."""
    eng = Engine(tiny, paged_kv=True, decode_kernel="pallas",
                 sample_on_device=False, max_slots=1, max_len=32,
                 auto_start=False)
    gw = Gateway([eng], tenants=[
        TenantConfig("acme", priority="interactive", max_queue=1)],
        start=False)
    try:
        creq = parse_completion_request(
            json.dumps({"prompt": [1, 2, 3], "max_tokens": 2}).encode(),
            has_tokenizer=False)
        gw.admit(creq, "acme")                        # fills max_queue=1
        j = journey.begin("slo-shed-j")
        with pytest.raises(AdmissionError, match="queue is full"):
            gw.admit(creq, "acme", journey=j)
        assert j.attrs["tenant"] == "acme"
        assert j.attrs["priority"] == "interactive"
        gw._drain_ev.set()
        with pytest.raises(AdmissionError, match="draining"):
            gw.admit(creq, "acme")
        gw._drain_ev.clear()
        snap = gw.window.snapshot(by="tenant")
        assert snap["keys"]["acme"]["shed"] == 2
        assert snap["keys"]["acme"]["shed_reasons"] == {
            "tenant_queue_full": 1, "draining": 1}
        assert gw.window.snapshot(by="class")["keys"]["interactive"][
            "shed"] == 2
    finally:
        journey.clear()
        gw.shutdown()
        eng.shutdown()


class _Stub:
    """Engine-shaped replica for the JAX gateway whose payload keys the
    port's are held to."""

    tokenizer, max_len, max_slots = None, 64, 2

    def load(self):
        return {"queue_depth": 0, "slots_in_use": 0, "cached_slots": 0,
                "max_slots": 2, "max_queue": 16, "max_len": 64,
                "alive": True, "draining": False}

    def shutdown(self):
        pass


def _jax_slo_state(objective_kw, incident_dir):
    """The JAX SLO engine's ``/debug/slo`` payload after one firing
    tick, and its incident ring."""
    gw = JaxGateway([_Stub()], tenants=[JaxTenantConfig("acme")],
                    start=False)
    eng = jax_slo.SloEngine(gw, [jax_slo.SloObjective(**objective_kw)],
                            start=False, incident_dir=incident_dir)
    try:
        now = time.perf_counter()
        for i in range(4):
            gw.window.observe_sample(now=now, ttft_s=1.0, tenant="acme")
        eng.tick(now=now)
        eng.tick(now=now + 0.01)
        return eng.debug_state()
    finally:
        gw.shutdown()


def _keys(payload):
    """The payload's key tree: each dict's keys, a list by its first
    item."""
    if isinstance(payload, dict):
        return {k: _keys(v) for k, v in payload.items()
                if k not in ("keys", "phase_share", "outcomes",
                             "shed_reasons", "attrs")}
    if isinstance(payload, list) and payload:
        return [_keys(payload[0])]
    return None


def test_http_slo_engine_end_to_end(tiny, tmp_path):
    """A live port gateway with the SLO engine on: a breaching workload
    fires the fast-burn alert, the incident bundle correlates the planes
    and renders through ``tools/incident_report.py``, ``/debug/slo`` and
    ``/debug/incidents`` answer with the JAX engine's keys, the gauges
    export, and decode stays one signature."""
    from tools.incident_report import render

    eng = Engine(tiny, paged_kv=True, decode_kernel="pallas",
                 sample_on_device=False, max_slots=2, max_len=32, max_queue=16)
    objective = dict(name="ttft-tight", signal="ttft_p99", target=0.9,
                     threshold_s=1e-4, fast_window_s=5.0, fast_burn=5.0,
                     slow_window_s=30.0, slow_burn=2.0, fire_ticks=2,
                     resolve_ticks=2, min_events=3)
    with start_gateway([eng], own_engines=True,
                       slo_objectives=[slo.SloObjective(**objective)],
                       slo_tick_s=0.1,
                       slo_incident_dir=str(tmp_path)) as stack:
        port = stack.port
        assert stack.gateway.slo_engine is stack.slo_engine
        for _ in range(4):
            status, _, _ = _post(port, {"prompt": [5, 17, 3],
                                        "max_tokens": 2},
                                 headers={"X-Tenant": "acme"})
            assert status == 200
        deadline = time.time() + 60.0
        state = None
        while time.time() < deadline:
            status, raw = _get(port, "/debug/slo")
            assert status == 200
            state = json.loads(raw)
            if any(tr["to"] == "firing" for tr in state["transitions"]) \
                    and state["incidents"]:
                break
            time.sleep(0.1)
        assert state["incidents"], "fast-burn alert never fired"
        assert stack.slo_engine.firing()[0]["objective"] == "ttft-tight"
        assert any(a["state"] == "firing" for a in state["alerts"])
        assert _keys(state) == _keys(_jax_slo_state(objective,
                                                 str(tmp_path / "jax")))

        inc_id = state["incidents"][-1]["id"]
        status, raw = _get(port, "/debug/incidents")
        listing = json.loads(raw)
        assert status == 200 and list(listing) == ["incidents"]
        assert any(m["id"] == inc_id for m in listing["incidents"])
        status, raw = _get(port, f"/debug/incidents/{inc_id}")
        assert status == 200
        bundle = json.loads(raw)
        assert bundle["schema"] == slo.INCIDENT_SCHEMA
        assert bundle["window"]["global"]["requests"] >= 3
        assert "acme" in bundle["window"]["by_tenant"]["keys"]
        assert "perf" in bundle and "memory" in bundle
        assert bundle["fleet"]["alive"] == 1
        assert bundle["fleet"]["autoscaler"] is None
        assert bundle["slowest_journeys"]
        assert any(e.get("kind") == "alert"
                   for e in bundle["flight_events"])
        status, raw = _get(port, "/debug/incidents/inc-nope")
        assert status == 404
        assert json.loads(raw)["error"]["code"] == "incident_not_found"
        sheet = render(bundle)
        assert inc_id in sheet and "ttft-tight" in sheet

        text = _get(port, "/metrics")[1].decode()
        for name in (slo.SLO_ATTAINMENT, slo.SLO_BURN_RATE,
                     slo.SLO_BUDGET_REMAINING, slo.SLO_ALERTS):
            assert name in text
        assert eng.compile_stats()["decode_compiles"] == 1
    assert not stack.slo_engine._thread.is_alive()


def test_http_slo_404_without_engine(tiny):
    eng = Engine(tiny, paged_kv=True, decode_kernel="pallas",
                 sample_on_device=False, max_slots=1, max_len=32,
                 auto_start=False)
    with start_gateway([eng], own_engines=True) as stack:
        for path in ("/debug/slo", "/debug/incidents",
                     "/debug/incidents/inc-1"):
            status, raw = _get(stack.port, path)
            assert status == 404
            assert json.loads(raw)["error"]["code"] == "no_slo_engine"
