"""The port's autoscaler and ``FleetSim`` against the JAX package's.

``paddle_tpu_torch.serving.autoscaler`` is the port's copy of
``paddle_tpu/serving/autoscaler.py``.  ``ScalePolicy`` is held to the JAX
package decision for decision over the same feed sequences (hysteresis,
the three breach reasons, idleness clamped at the floor, cooldowns and
flap resistance), and ``FleetSim`` on the seeded traces gives the JAX
package's result dicts (static fleets 1-5, autoscaled, with a warm
spare).  Then the port alone, over the router, the gateway and stub
replicas: membership changes under concurrent picks, draining as a third
state, the per-engine gauge series deleted on removal, admission parking
while a scale-up is pending, the scale-aware ``Retry-After``, the crash
matrix at the three new fault seams, and, on gpt-tiny over HTTP, a
scale-up and a drain-based scale-down triggered through
``Autoscaler.trigger`` with zero lost requests, one decode signature a
build and ``/debug/fleet`` carrying the JAX package's keys.  Scale events
are triggered, never waited for on a clock; every wait is bounded.
"""
import http.client
import json
import threading
import time

import pytest
import torch

pytest.importorskip("jax")

from paddle_tpu.serving import Autoscaler as JaxAutoscaler
from paddle_tpu.serving import FleetSim as JaxFleetSim
from paddle_tpu.serving import ScalePolicy as JaxScalePolicy
from paddle_tpu.serving.gateway import Gateway as JaxGateway
from paddle_tpu.serving.gateway import TenantConfig as JaxTenantConfig
from tools import load_gen as jax_load_gen

from paddle_tpu_torch.models import build_gpt
from paddle_tpu_torch.observability import flight, registry
from paddle_tpu_torch.serving import (Autoscaler, Engine, EngineSupervisor,
                                      FleetSim, ScalePolicy)
from paddle_tpu_torch.serving import autoscaler as autoscaler_mod
from paddle_tpu_torch.serving.autoscaler import (FLEET_ALIVE, FLEET_DESIRED,
                                                 FLEET_DRAINING,
                                                 FLEET_SCALE_EVENTS)
from paddle_tpu_torch.serving.engine import QueueFullError
from paddle_tpu_torch.serving.gateway import (Gateway, GatewayClosedError,
                                              TenantConfig)
from paddle_tpu_torch.serving.gateway import router as router_mod
from paddle_tpu_torch.serving.gateway import start_gateway
from paddle_tpu_torch.serving.gateway.admission import AdmissionError
from paddle_tpu_torch.serving.gateway.protocol import parse_completion_request
from paddle_tpu_torch.serving.gateway.router import (GATEWAY_ENGINE_SLOTS,
                                                     EngineRouter,
                                                     NoEngineAvailableError)
from paddle_tpu_torch.serving.gateway.shed import LoadShedder
from paddle_tpu_torch.testing import faults
from paddle_tpu_torch.testing.load_gen import make_trace

torch.set_num_threads(1)

TIMEOUT = 120


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


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


def _wait(pred, timeout=60.0, period=0.01):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if pred():
            return True
        time.sleep(period)
    return False


def _creq(max_tokens=3, prompt=(1, 2, 3), **extra):
    payload = {"prompt": list(prompt), "max_tokens": max_tokens}
    payload.update(extra)
    return parse_completion_request(json.dumps(payload).encode(),
                                    has_tokenizer=False)


class StubEngine:
    """Engine-shaped fake for router / autoscaler units: O(1) load
    snapshot, instant drain, warm health — no devices, no threads."""

    def __init__(self, max_slots=2, alive=True):
        self.tokenizer = None
        self.max_len = 64
        self.max_slots = max_slots
        self.alive = alive
        self.draining = False
        self.slots = 0
        self.queue = 0
        self.shut_down = False

    def load(self):
        return {"queue_depth": self.queue, "slots_in_use": self.slots,
                "cached_slots": 0, "max_slots": self.max_slots,
                "max_queue": 16, "max_len": self.max_len,
                "alive": self.alive and not self.draining,
                "draining": self.draining}

    def drain(self, deadline_s=30.0):
        self.draining = True
        return True

    def shutdown(self):
        self.shut_down = True
        self.alive = False

    def health(self):
        return {"warm": True, "dead": not self.alive}


def _feed(est=None, qw_p99=0.0, qw_n=0, shed_rate=0.0, requests=0,
          shed=0, queue_depth=0, slots_in_use=0, total_slots=4,
          prefill=0.0):
    return {"est_ttft_s": est, "prefill_s": prefill,
            "queue_wait_s": {"p50": qw_p99 / 2, "p99": qw_p99, "n": qw_n},
            "shed_rate": shed_rate, "requests": requests, "shed": shed,
            "queue_depth": queue_depth, "slots_in_use": slots_in_use,
            "total_slots": total_slots}


POL = dict(slo_ttft_s=1.0, headroom_frac=0.25, queue_wait_p99_s=0.5,
           shed_rate=0.1, up_ticks=2, idle_ticks=3, cooldown_up_s=5.0,
           cooldown_down_s=10.0)


def _pol(cls=ScalePolicy, **kw):
    return cls(**dict(POL, **kw))


def _decisions(cls, steps, **kw):
    """Feed ``steps`` (feed, decide kwargs, now, event or None) to one
    policy of ``cls``: its decisions and snapshots, one a step."""
    pol = _pol(cls, **kw)
    out = []
    for feed, dkw, now, event in steps:
        out.append((tuple(pol.decide(feed, now=now, **dkw)),
                    pol.snapshot()))
        if event is not None:
            pol.note_event(event, now)
    return out


def _held(steps, **kw):
    """The port's decisions over ``steps``, which must equal the JAX
    policy's."""
    got = _decisions(ScalePolicy, steps, **kw)
    assert got == _decisions(JaxScalePolicy, steps, **kw)
    return [d for d, _ in got]


ONE = dict(replicas=1, min_replicas=1, max_replicas=4)
TWO = dict(replicas=2, min_replicas=1, max_replicas=4)


# -- policy units, decision for decision --------------------------------------

def test_policy_up_on_headroom_collapse_needs_sustained_breach():
    hot = _feed(est=0.9)                       # > 0.75 * 1.0
    assert _held([(hot, ONE, 0.0, None), (hot, ONE, 1.0, None)]) == [
        (None, ""), ("up", "ttft_headroom")]
    # a recovered tick resets the streak: the breach must re-sustain
    assert _held([(hot, ONE, 0.0, None), (_feed(est=0.1), ONE, 1.0, None),
                  (hot, ONE, 2.0, None), (hot, ONE, 3.0, None)]) == [
        (None, ""), (None, ""), (None, ""), ("up", "ttft_headroom")]


@pytest.mark.parametrize("feed,kw,want", [
    (_feed(qw_p99=0.8, qw_n=5), ONE, ("up", "queue_wait_p99")),
    (_feed(shed_rate=0.5, requests=5, shed=5), ONE, ("up", "shed_rate")),
    (_feed(est=0.9), dict(replicas=4, min_replicas=1, max_replicas=4),
     (None, "")),                              # at max: recorded, no fire
    (_feed(est=0.9, prefill=0.9), ONE, (None, "")),   # floor blows the SLO
], ids=["queue_wait", "shed_rate", "at_max", "unfixable_floor"])
def test_policy_up_reasons_queue_wait_and_shed_rate(feed, kw, want):
    assert _held([(feed, kw, 0.0, None)], up_ticks=1) == [want]


def test_policy_down_on_sustained_idle_clamped_at_min():
    idle = _feed(est=0.05)
    assert _held([(idle, TWO, float(t), None) for t in range(3)]) == [
        (None, ""), (None, ""), ("down", "idle")]
    assert _held([(idle, ONE, 0.0, None)], idle_ticks=1) == [(None, "")]
    # the prefill floor does not block idleness: zero backlog shrinks
    assert _held([(_feed(est=0.9, prefill=0.9), TWO, 0.0, None)],
                 idle_ticks=1) == [("down", "idle")]


def test_policy_cooldowns_and_flap_resistance():
    hot, idle = _feed(est=0.9), _feed(est=0.05)
    steps = [(hot, TWO, 0.0, "up")]
    steps += [(idle, TWO, t, None) for t in (0.5, 3.0, 9.0)]
    steps += [(idle, TWO, 10.5, "down"), (hot, TWO, 11.0, None),
              (hot, TWO, 16.0, None)]
    got = _held(steps, up_ticks=1, idle_ticks=1)
    assert got == [("up", "ttft_headroom"), (None, ""), (None, ""),
                   (None, ""), ("down", "idle"), (None, ""),
                   ("up", "ttft_headroom")]


# -- router membership --------------------------------------------------------

def test_router_add_remove_under_concurrent_dispatch():
    router = EngineRouter([StubEngine(), StubEngine()], names=["a", "b"])
    stop = threading.Event()
    errors = []

    def dispatch_loop():
        while not stop.is_set():
            try:
                _, eng = router.pick()
                assert eng.load()["alive"]
                router.loads()
                router.total_slots()
                router.has_headroom()
            except NoEngineAvailableError:
                pass
            except Exception as e:  # noqa: BLE001 — the test's point
                errors.append(e)
                return

    threads = [threading.Thread(target=dispatch_loop) for _ in range(4)]
    for th in threads:
        th.start()
    for i in range(50):
        router.add_replica(f"dyn{i}", StubEngine())
        time.sleep(0.001)
        router.remove_replica(f"dyn{i}")
    stop.set()
    for th in threads:
        th.join(timeout=10)
    assert not errors, errors
    assert router.names == ["a", "b"]
    with pytest.raises(ValueError):
        router.add_replica("a", StubEngine())
    with pytest.raises(KeyError):
        router.remove_replica("nope")


def test_router_draining_is_third_state_not_dead():
    a, b = StubEngine(), StubEngine()
    router = EngineRouter([a, b], names=["a", "b"])
    b.draining = True
    assert {router.pick()[0] for _ in range(8)} == {"a"}
    assert router.any_alive() and router.any_draining()
    assert router.total_slots() == a.max_slots
    assert router.has_headroom()
    a.alive = False
    assert not router.any_alive() and router.any_draining()
    with pytest.raises(NoEngineAvailableError):
        router.pick()
    assert not router.has_headroom()


def test_router_remove_deletes_stale_slots_gauge_series():
    registry().reset()
    a, b = StubEngine(), StubEngine()
    a.slots, b.slots = 1, 2
    router = EngineRouter([a, b], names=["keep", "gone"])
    router.loads()
    gauge = registry().get(GATEWAY_ENGINE_SLOTS)

    def names():
        return {dict(lbl)["engine"] for lbl, _ in gauge.series()}

    assert names() == {"keep", "gone"}
    router.remove_replica("gone")
    assert names() == {"keep"}
    gauge.set(2.0, labels={"engine": "gone"})        # a racing re-export
    router.loads()
    assert names() == {"keep"}


def test_fleet_metric_names_are_the_jax_packages():
    from paddle_tpu.serving import autoscaler as jax_autoscaler
    for name in ("FLEET_DESIRED", "FLEET_ALIVE", "FLEET_DRAINING",
                 "FLEET_SCALE_EVENTS"):
        assert getattr(autoscaler_mod, name) == getattr(jax_autoscaler, name)
        assert name in autoscaler_mod.__all__
    assert router_mod.FLEET_ALIVE is autoscaler_mod.FLEET_ALIVE


# -- the gateway's scale coordination -----------------------------------------

class _Scaler:
    def __init__(self, eta):
        self.eta = eta

    def scale_pending(self):
        return True

    def expected_ready_s(self):
        return self.eta

    def fleet_stats(self):
        return {"stub": True}


def test_gateway_parks_work_while_draining_plus_scale_pending():
    """Admission parks (no 503) while the only pickable capacity drains
    or a scale-up builds; a fleet truly dead still 503s."""
    stub = StubEngine()
    gw = Gateway([stub], tenants=[TenantConfig("t")], start=False)
    gw2 = Gateway([StubEngine(alive=False)], tenants=[TenantConfig("t")],
                  start=False)
    try:
        stub.draining = True
        assert not gw.admit(_creq(), "t").done_ev.is_set()
        stub.draining, stub.alive = False, False
        with pytest.raises(NoEngineAvailableError):
            gw.admit(_creq(), "t")
        gw.attach_autoscaler(_Scaler(0.7))
        assert gw.autoscaler is not None and gw._fleet_pending()
        assert not gw.admit(_creq(), "t").done_ev.is_set()
        assert gw.fleet_stats()["autoscaler"] == {"stub": True}
        with pytest.raises(NoEngineAvailableError):
            gw2.admit(_creq(), "t")
    finally:
        gw.shutdown()
        gw2.shutdown()


def test_shed_retry_after_capped_at_expected_warmup():
    shedder = LoadShedder()
    shedder.seed(prefill_s=5.0, token_s=1.0)
    gw = Gateway([StubEngine()], tenants=[TenantConfig("t")],
                 shedder=shedder, start=False)
    try:
        with pytest.raises(AdmissionError) as e1:
            gw.admit(_creq(deadline_ms=100), "t")
        baseline = e1.value.retry_after_s
        assert baseline > 2.0, baseline
        gw.attach_autoscaler(_Scaler(1.2))
        with pytest.raises(AdmissionError) as e2:
            gw.admit(_creq(deadline_ms=100), "t")
        assert e2.value.retry_after_s <= 1.2 < baseline
    finally:
        gw.shutdown()


class _FullEngine(StubEngine):
    """Alive, but its queue refuses every submit."""

    def submit(self, *args, **kwargs):
        raise QueueFullError("queue full")


def test_dispatch_parks_when_the_tried_replicas_are_full():
    """A request whose only live replica is full while the other is down
    waits at the head of its queue (it is not failed with a 503); the
    gateway's shutdown then fails it as closed."""
    gw = Gateway([_FullEngine(), StubEngine(alive=False)],
                 tenants=[TenantConfig("t")])
    try:
        item = gw.admit(_creq(), "t")
        time.sleep(0.3)                  # the dispatcher retries meanwhile
        assert not item.done_ev.is_set(), item.final_error
    finally:
        gw.shutdown()
    assert item.done_ev.wait(10)
    assert isinstance(item.final_error, GatewayClosedError)


def _gated_factory(release, built):
    def factory():
        assert release.wait(30)
        e = StubEngine()
        built.append(e)
        return e
    return factory


def test_trigger_during_an_op_waits_for_it():
    """A scale event triggered while another builds runs after it (one op
    at a time) instead of being dropped."""
    release, built = threading.Event(), []
    gw = Gateway([StubEngine()], tenants=[TenantConfig("t")], start=False)
    auto = Autoscaler(gw, _gated_factory(release, built), min_replicas=1,
                      max_replicas=3, policy=_pol(), poll_interval_s=0.01,
                      name_prefix="as")
    try:
        auto.trigger("up")
        assert _wait(lambda: auto.fleet_stats()["op"] is not None)
        auto.trigger("up")
        assert _wait(lambda: auto.scale_pending())
        release.set()
        assert _wait(lambda: len(gw.router.names) == 3), gw.router.names
        assert len(built) == 2 and auto.desired == 3
    finally:
        release.set()
        auto.shutdown()
        gw.shutdown()


def test_shutdown_joins_scale_and_warm_workers():
    """``shutdown`` returns only once its scale and warm-build workers
    have ended; a spare finished after the stop is torn down, never
    parked."""
    release, built = threading.Event(), []
    gw = Gateway([StubEngine()], tenants=[TenantConfig("t")], start=False)
    auto = Autoscaler(gw, _gated_factory(release, built), min_replicas=1,
                      max_replicas=3, policy=_pol(), poll_interval_s=0.01,
                      warm_pool=1, name_prefix="as")
    try:
        auto.trigger("up")
        assert _wait(lambda: auto.fleet_stats()["op"] is not None and
                     auto.fleet_stats()["warm_pool"]["building"])
        workers = [th for th in threading.enumerate() if th.name in (
            "paddle-tpu-scale-up", "paddle-tpu-warm-pool")]
        assert len(workers) == 2
        timer = threading.Timer(0.2, release.set)
        timer.start()
        auto.shutdown()
        assert not any(th.is_alive() for th in workers)
        assert auto.fleet_stats()["warm_pool"]["parked"] == []
        spares = [e for e in built if e not in gw.router.engines]
        assert spares and all(e.shut_down for e in spares)
    finally:
        release.set()
        auto.shutdown()
        gw.shutdown()


# -- crash matrix -------------------------------------------------------------

@pytest.mark.parametrize("seam", ["scale.up_build", "scale.down_drain",
                                  "autoscaler.tick"])
def test_crash_at_scale_seam_is_absorbed_and_retried(seam):
    gw = Gateway([StubEngine()], tenants=[TenantConfig("t")], start=False)
    auto = Autoscaler(gw, StubEngine, min_replicas=1, max_replicas=3,
                      policy=_pol(), poll_interval_s=0.01,
                      drain_deadline_s=1.0, name_prefix="as")
    try:
        if seam == "scale.up_build":
            faults.arm(seam, times=1)
            auto.trigger("up")
            assert _wait(lambda: len(gw.router.names) == 2)
            assert faults.hits(seam) >= 2
            failed = "scale_up_failed"
        elif seam == "scale.down_drain":
            auto.trigger("up")
            assert _wait(lambda: len(gw.router.names) == 2)
            faults.arm(seam, times=1)
            auto.trigger("down")
            assert _wait(lambda: len(gw.router.names) == 1)
            assert faults.hits(seam) >= 2
            failed = "scale_down_failed"
        else:
            faults.arm(seam, times=3)
            assert _wait(lambda: faults.hits(seam) >= 3)
            faults.disarm(seam)
            auto.trigger("up")
            assert _wait(lambda: len(gw.router.names) == 2)
            failed = "tick_error"
        assert failed in {e["name"] for e in flight.events("autoscaler")}
        assert 1 <= len(gw.router.names) <= 3
        assert _wait(lambda: auto.desired == len(gw.router.names))
    finally:
        faults.reset()
        auto.shutdown()
        gw.shutdown()


# -- the warm pool's build on a real engine -----------------------------------

class _FailingEngine(StubEngine):
    """Has the engine surface; its warm-up request fails."""

    def submit(self, prompt, max_new_tokens=16):
        raise RuntimeError("no decode graph")

    def compile_stats(self):
        return {"decode_compiles": 0}


def test_warm_build_that_cannot_prewarm_is_a_failed_build():
    """A replica with the engine surface whose prewarm fails is never
    parked: the build fails, is torn down and is recorded."""
    built = []

    def factory():
        e = _FailingEngine()
        built.append(e)
        return e

    gw = Gateway([StubEngine()], tenants=[TenantConfig("t")], start=False)
    auto = Autoscaler(gw, factory, min_replicas=1, max_replicas=2,
                      policy=_pol(), poll_interval_s=0.01, warm_pool=1)
    try:
        assert _wait(lambda: len(built) >= 2)
        assert _wait(lambda: all(e.shut_down for e in built[:2]))
        assert auto.fleet_stats()["warm_pool"]["parked"] == []
        assert "warm_build_failed" in {
            e["name"] for e in flight.events("autoscaler")}
    finally:
        auto.shutdown()
        gw.shutdown()


# -- closed loop over real engines --------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(21)
    return build_gpt("gpt-tiny", device="cpu", max_position_embeddings=128)


def _client(port, i, results, lock):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt": [1 + i % 7, 2, 3],
                                 "max_tokens": 4}).encode(),
                     {"Content-Type": "application/json", "X-Tenant": "t"})
        r = conn.getresponse()
        body = json.loads(r.read())
        n = len(body["choices"][0]["token_ids"]) if r.status == 200 else 0
    finally:
        conn.close()
    with lock:
        results.append((r.status, n))


def test_scale_up_then_drain_down_end_to_end(tiny):
    """A triggered scale-up builds a supervised replica that joins the
    router under HTTP load; a triggered scale-down DRAINS a replica (its
    in-flight work completes), removes and shuts it down.  Zero lost
    requests, one decode signature a build, the fleet metrics and
    flight events record both events."""
    registry().reset()
    built = []

    def factory():
        def build():
            e = Engine(tiny, paged_kv=True, decode_kernel="pallas",
                       sample_on_device=False, max_slots=2, max_len=48,
                       max_queue=32)
            built.append(e)
            return e
        return EngineSupervisor(build, poll_interval_s=0.02)

    stack = start_gateway([factory()], own_engines=True,
                          tenants=[TenantConfig("t", max_queue=64)])
    park = ScalePolicy(slo_ttft_s=1e6, up_ticks=10 ** 6, idle_ticks=10 ** 6,
                       cooldown_up_s=3600.0, cooldown_down_s=3600.0)
    auto = Autoscaler(stack, factory, min_replicas=1, max_replicas=2,
                      policy=park, poll_interval_s=0.05,
                      drain_deadline_s=30.0, build_s_hint=2.0)
    gw = stack.gateway
    results, lock = [], threading.Lock()
    try:
        _client(stack.port, 0, results, lock)         # warm the replica
        threads = [threading.Thread(target=_client,
                                    args=(stack.port, i, results, lock))
                   for i in range(1, 9)]
        auto.trigger("up", reason="test")
        for th in threads:
            th.start()
        assert _wait(lambda: len(gw.router.names) == 2), gw.router.names
        for th in threads:
            th.join(timeout=TIMEOUT)
        more = [threading.Thread(target=_client,
                                 args=(stack.port, i, results, lock))
                for i in range(9, 13)]
        for th in more:
            th.start()
        auto.trigger("down", reason="test")
        assert _wait(lambda: len(gw.router.names) == 1), gw.router.names
        for th in more:
            th.join(timeout=TIMEOUT)
        assert len(results) == 13
        assert all(s == 200 and n == 4 for s, n in results), results
        drained = [e for e in built if e._stop]
        assert len(drained) == 1 and drained[0]._page_alloc.n_used == 0
        assert all(e.compile_stats()["decode_compiles"] <= 1 for e in built)
        ev = {e["name"] for e in flight.events("autoscaler")}
        assert {"scale_up_begin", "scale_up", "scale_down_begin",
                "scale_down"} <= ev, ev
        counter = registry().get(FLEET_SCALE_EVENTS)
        assert counter.value({"direction": "up", "reason": "test"}) == 1.0
        assert counter.value({"direction": "down", "reason": "test"}) == 1.0
        assert _wait(lambda: registry().get(FLEET_DESIRED).value() == 1.0)
        assert registry().get(FLEET_ALIVE).value() >= 1.0
        assert registry().get(FLEET_DRAINING) is not None
    finally:
        auto.shutdown()
        stack.close()
        for e in built:
            e.shutdown()


def _jax_fleet():
    """The JAX gateway's ``/debug/fleet`` payload with an autoscaler
    attached (stub replicas)."""
    gw = JaxGateway([StubEngine()], tenants=[JaxTenantConfig("t")],
                    start=False)
    auto = JaxAutoscaler(gw, StubEngine, min_replicas=1, max_replicas=2,
                         policy=_pol(JaxScalePolicy), start=False)
    try:
        return gw.fleet_stats()
    finally:
        auto.shutdown()
        gw.shutdown()


def test_debug_fleet_endpoint_and_metrics_export(tiny):
    """GET /debug/fleet serves the fleet state with the JAX gateway's
    keys, and /metrics exports the fleet gauges."""
    registry().reset()
    eng = Engine(tiny, paged_kv=True, decode_kernel="pallas",
                 sample_on_device=False, max_slots=2, max_len=48)
    stack = start_gateway([eng], own_engines=True,
                          tenants=[TenantConfig("t")])
    auto = Autoscaler(stack, lambda: StubEngine(), min_replicas=1,
                      max_replicas=2, policy=_pol(), poll_interval_s=0.05)
    try:
        assert _wait(lambda: registry().get(FLEET_DESIRED) is not None)
        conn = http.client.HTTPConnection("127.0.0.1", stack.port,
                                          timeout=TIMEOUT)
        conn.request("GET", "/debug/fleet")
        r = conn.getresponse()
        fleet = json.loads(r.read())
        conn.close()
        assert r.status == 200
        assert fleet["alive"] == 1 and fleet["draining"] == 0
        assert fleet["replicas"]["engine0"]["alive"]
        a = fleet["autoscaler"]
        assert a["min_replicas"] == 1 and a["max_replicas"] == 2
        assert a["desired"] == 1 and a["op"] is None
        assert a["policy"]["slo_ttft_s"] == 1.0
        want = _jax_fleet()
        assert set(fleet) == set(want)
        assert set(a) == set(want["autoscaler"])
        assert set(a["policy"]) == set(want["autoscaler"]["policy"])
        assert set(a["warm_pool"]) == set(want["autoscaler"]["warm_pool"])
        assert set(fleet["replicas"]["engine0"]) == set(
            want["replicas"]["engine0"])
        conn = http.client.HTTPConnection("127.0.0.1", stack.port,
                                          timeout=TIMEOUT)
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
        conn.close()
        for name in (FLEET_DESIRED, FLEET_ALIVE, FLEET_DRAINING):
            assert name in text, name
    finally:
        auto.shutdown()
        stack.close()


# -- simulation mode, both packages -------------------------------------------

def _sims(sim_cls, pol_cls, trace, kw, auto_kw, pol_kw):
    auto = sim_cls(pol_cls(**pol_kw), **auto_kw, **kw).run(trace)
    statics = {n: sim_cls(None, min_replicas=n, max_replicas=n,
                          start_replicas=n, **kw).run(trace)
               for n in range(1, 6)}
    return auto, statics


FLASH_KW = dict(slots_per_replica=4, prefill_s=0.05, token_s=0.01)


@pytest.mark.parametrize("warm_pool", [0, 1], ids=["cold", "warm_pool"])
def test_sim_closed_loop_beats_static_fleets_on_flash_crowd(warm_pool):
    """On the seeded flash-crowd trace the autoscaled fleet matches the
    best static fleet's attainment with zero flaps, and without a spare
    it spends fewer replica-seconds (the parked spare is charged its
    seconds); every result dict equals the JAX package's."""
    trace = make_trace(60.0, 4.0, seed=0, flash_mult=8.0,
                       flash_duration_s=10.0, prompt_mean=12.0,
                       out_mean=10.0, deadline_s=3.0)
    pol_kw = dict(slo_ttft_s=1.0, up_ticks=2, idle_ticks=8,
                  cooldown_up_s=2.0, cooldown_down_s=6.0)
    auto_kw = dict(min_replicas=1, max_replicas=5, build_s=1.5,
                   warm_pool=warm_pool, route_in_s=0.05)
    auto, statics = _sims(FleetSim, ScalePolicy, trace, FLASH_KW, auto_kw,
                          pol_kw)
    assert _close((auto, statics), _sims(JaxFleetSim, JaxScalePolicy, trace,
                                         FLASH_KW, auto_kw, pol_kw))
    best = max(s["slo_attainment"] for s in statics.values())
    cheapest = min(s["replica_seconds"] for s in statics.values()
                   if s["slo_attainment"] >= best)
    assert auto["slo_attainment"] >= best - 1e-9
    if not warm_pool:
        assert auto["replica_seconds"] < cheapest
    assert auto["flaps"] == 0, auto["events"]
    assert any(e["direction"] == "up" for e in auto["events"])
    assert auto["completed"] + auto["shed"] == auto["arrivals"]
    if warm_pool:
        assert auto["warm"]["warm_route_ins"] >= 1
        assert auto["warm"]["max_warm_reaction_s"] < 1.5
    else:
        assert auto["warm"] is None


def test_sim_scale_down_drains_and_loses_nothing():
    trace = make_trace(40.0, 3.0, seed=1, flash_mult=10.0, flash_at=0.2,
                       flash_duration_s=6.0, out_mean=20.0)
    trace += [{"t": 40.0 + i, "prompt_len": 1, "max_tokens": 1}
              for i in range(25)]
    pol_kw = dict(slo_ttft_s=1.0, up_ticks=1, idle_ticks=4,
                  cooldown_up_s=1.0, cooldown_down_s=3.0)
    kw = dict(min_replicas=1, max_replicas=4, slots_per_replica=2,
              prefill_s=0.05, token_s=0.02, build_s=1.0)
    r = FleetSim(ScalePolicy(**pol_kw), **kw).run(trace)
    assert _close(r, JaxFleetSim(JaxScalePolicy(**pol_kw), **kw).run(trace))
    assert r["completed"] == r["arrivals"] and r["shed"] == 0
    assert [e for e in r["events"] if e["direction"] == "down"]
    assert r["final_replicas"] <= 2
    assert r["final_replicas"] < r["peak_replicas"]
    assert r["flaps"] == 0


def test_sim_flap_resistance_under_oscillating_load():
    trace = []
    for burst in range(6):
        t0 = burst * 10.0
        trace += [{"t": t0 + i * 0.05, "prompt_len": 8, "max_tokens": 8}
                  for i in range(100)]
    pol_kw = dict(slo_ttft_s=0.5, up_ticks=2, idle_ticks=4,
                  cooldown_up_s=8.0, cooldown_down_s=20.0)
    kw = dict(min_replicas=1, max_replicas=4, slots_per_replica=4,
              prefill_s=0.05, token_s=0.01, build_s=1.0)
    r = FleetSim(ScalePolicy(**pol_kw), **kw).run(trace)
    assert _close(r, JaxFleetSim(JaxScalePolicy(**pol_kw), **kw).run(trace))
    assert r["flaps"] == 0, r["events"]
    for a, b in zip(r["events"], r["events"][1:]):
        if a["direction"] != b["direction"]:
            assert b["t"] - a["t"] >= 8.0, (a, b)


# -- the trace generator ------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_load_gen_traces_match_the_tools_copy(seed):
    kw = dict(flash_mult=6.0, flash_at=0.5, flash_duration_s=8.0,
              deadline_s=2.0, adapters=["hot", "a", "b"])
    assert make_trace(60.0, 4.0, seed=seed, **kw) == \
        jax_load_gen.make_trace(60.0, 4.0, seed=seed, **kw)
    from paddle_tpu_torch.testing.load_gen import make_conversation_trace
    assert make_conversation_trace(40.0, 1.0, seed=seed, deadline_s=3.0) == \
        jax_load_gen.make_conversation_trace(40.0, 1.0, seed=seed,
                                             deadline_s=3.0)


def test_load_gen_trace_seeded_diurnal_flash_heavy_tail():
    kw = dict(flash_mult=6.0, flash_at=0.5, flash_duration_s=8.0,
              deadline_s=2.0)
    tr = make_trace(60.0, 4.0, seed=0, **kw)
    assert tr == make_trace(60.0, 4.0, seed=0, **kw)
    assert tr != make_trace(60.0, 4.0, seed=1, **kw)
    ts = [e["t"] for e in tr]
    assert ts == sorted(ts) and ts[-1] < 60.0
    flash_rate = sum(1 for t in ts if 30.0 <= t < 38.0) / 8.0
    base_rate = sum(1 for t in ts if t < 30.0) / 30.0
    assert flash_rate > 2.5 * base_rate
    lens = sorted(e["prompt_len"] for e in tr)
    assert lens[int(len(lens) * 0.99)] >= 3 * lens[len(lens) // 2]
    assert all(e["deadline_s"] == 2.0 for e in tr)
    assert all(e["max_tokens"] >= 1 and e["prompt_len"] >= 1 for e in tr)
    assert all("deadline_s" not in e for e in make_trace(10.0, 2.0, seed=0))
    with pytest.raises(ValueError):
        make_trace(0.0, 1.0)
