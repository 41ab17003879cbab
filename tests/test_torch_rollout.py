"""The port's rolling upgrade against the JAX package's.

``paddle_tpu_torch.serving.rollout`` is the port's copy of
``paddle_tpu/serving/rollout.py``.  ``CanaryGate.judge`` gives the JAX
package's verdicts on the same windows.  Then, over stub fleets: a
rollout that replaces every replica by drain (never a kill), a canary
the gate bites rolled back with the incumbents untouched, a canary build
that keeps failing rolled back, typed misuse, the crash matrix at the
three ``rollout.*`` seams, the autoscaler's coordination (protected
replicas, scale-ups at the target revision, the ``Retry-After`` cap
shrinking during a build), the warm pool (park, route-in, refill, stale
revisions dropped) and ``FleetSim``'s warm pool against the JAX
package's; the router's adapter-locality tiebreak; drain and
``undrain`` on a never-warmed port engine; a port engine whose
``compile_stats`` fails is not judged as zero signatures; and a gpt-tiny
fleet upgraded over HTTP with zero lost requests and ``/debug/fleet``'s
rollout block carrying the JAX package's keys.  Every wait is bounded.
"""
import http.client
import json
import threading
import time

import pytest
import torch

pytest.importorskip("jax")

from paddle_tpu.serving import CanaryGate as JaxCanaryGate
from paddle_tpu.serving import FleetSim as JaxFleetSim
from paddle_tpu.serving import RolloutController as JaxRolloutController
from paddle_tpu.serving import ScalePolicy as JaxScalePolicy
from paddle_tpu.serving.gateway import Gateway as JaxGateway
from paddle_tpu.serving.gateway import TenantConfig as JaxTenantConfig

from paddle_tpu_torch.models import build_gpt
from paddle_tpu_torch.observability import flight, registry
from paddle_tpu_torch.serving import (Autoscaler, CanaryGate, Engine,
                                      EngineClosedError, FleetSim,
                                      RolloutController, RolloutError,
                                      RolloutRolledBack, ScalePolicy)
from paddle_tpu_torch.serving.autoscaler import FLEET_ALIVE
from paddle_tpu_torch.serving.gateway import (Gateway, TenantConfig,
                                              start_gateway)
from paddle_tpu_torch.serving.gateway.admission import AdmissionError
from paddle_tpu_torch.serving.gateway.protocol import parse_completion_request
from paddle_tpu_torch.serving.gateway.router import EngineRouter
from paddle_tpu_torch.serving.gateway.shed import LoadShedder
from paddle_tpu_torch.serving.rollout import FLEET_ROLLOUTS
from paddle_tpu_torch.testing import faults
from paddle_tpu_torch.testing.load_gen import make_trace

torch.set_num_threads(1)

TIMEOUT = 120


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


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
    """Engine-shaped fake for router / rollout units: O(1) load snapshot,
    instant drain (counted), parkable via undrain, an adapter-residency
    surface — no devices, no threads."""

    def __init__(self, max_slots=2, alive=True, resident=()):
        self.tokenizer = None
        self.max_len = 64
        self.max_slots = max_slots
        self.alive = alive
        self.draining = False
        self.slots = 0
        self.queue = 0
        self.shut_down = False
        self.drain_calls = 0
        self.resident = list(resident)

    def load(self):
        return {"queue_depth": self.queue, "slots_in_use": self.slots,
                "cached_slots": 0, "max_slots": self.max_slots,
                "max_queue": 16, "max_len": self.max_len,
                "alive": self.alive and not self.draining,
                "draining": self.draining}

    def drain(self, deadline_s=30.0):
        self.drain_calls += 1
        self.draining = True
        return True

    def undrain(self):
        if not self.alive:
            raise RuntimeError("undrain on a dead stub")
        self.draining = False

    def adapter_resident(self, name):
        return name in self.resident

    def shutdown(self):
        self.shut_down = True
        self.alive = False

    def health(self):
        return {"warm": True, "dead": not self.alive}


class StubRollout:
    """Duck-typed rollout controller: a fixed target revision with a
    build reported in flight."""

    def __init__(self, revision="r9", etas=(1.2,), building=True):
        self.rev = revision
        self.etas = list(etas)
        self.building = building

    def revision(self):
        return self.rev

    def factory(self):
        return StubEngine

    def protected(self):
        return frozenset()

    def active(self):
        return self.building

    def build_pending(self):
        return self.building

    def expected_ready_s(self):
        return self.etas.pop(0) if len(self.etas) > 1 else self.etas[0]

    def note_outcome(self, engine, ok, ttft_s=None):
        pass

    def stats(self):
        return {"stub": True}


def _pol(**kw):
    base = dict(slo_ttft_s=1.0, headroom_frac=0.25, queue_wait_p99_s=0.5,
                shed_rate=0.1, up_ticks=2, idle_ticks=3,
                cooldown_up_s=5.0, cooldown_down_s=10.0)
    base.update(kw)
    return ScalePolicy(**base)


def _quiet_gate(timeout_s=0.3):
    """Passes an untrafficked canary fast (stub fleets have no reaper)."""
    return CanaryGate(min_requests=4, timeout_s=timeout_s)


def _judged(kw, cases):
    """``CanaryGate(**kw).judge`` over ``cases`` in both packages: the
    port's verdicts, which must equal the JAX gate's."""
    got = [CanaryGate(**kw).judge(*c) for c in cases]
    assert got == [JaxCanaryGate(**kw).judge(*c) for c in cases]
    assert CanaryGate(**kw).snapshot() == JaxCanaryGate(**kw).snapshot()
    return got


# -- canary-gate judgment -----------------------------------------------------

def test_gate_waits_below_min_requests_then_quiet_passes():
    can = {"n": 3, "errors": 0, "ttft": [0.01] * 3}
    inc = {"n": 50, "errors": 0, "ttft": [0.01] * 50}
    wait, quiet = _judged(dict(min_requests=8, timeout_s=10.0),
                          [(can, inc, 1, 1.0), (can, inc, 1, 10.5)])
    assert wait is None
    assert quiet[:2] == (True, "quiet")
    with pytest.raises(ValueError):
        CanaryGate(min_requests=0)


def test_gate_decode_signatures_bites_before_everything():
    can = {"n": 0, "errors": 0, "ttft": []}
    (verdict,) = _judged(dict(min_requests=8, max_decode_signatures=1),
                         [(can, can, 3, 0.0)])
    assert verdict[:2] == (False, "decode_signatures")


def test_gate_error_rate_judged_against_incumbent_plus_slack():
    inc = {"n": 40, "errors": 2, "ttft": [0.01] * 40}
    bad = {"n": 10, "errors": 5, "ttft": [0.01] * 10}
    near = {"n": 10, "errors": 1, "ttft": [0.01] * 10}
    got = _judged(dict(min_requests=4, err_rate_slack=0.10),
                  [(bad, inc, 1, 1.0), (near, inc, 1, 1.0)])
    assert got[0][:2] == (False, "error_rate")
    assert got[1][:2] == (True, "passed")


def test_gate_ttft_p99_needs_ratio_and_absolute_floor():
    kw = dict(min_requests=4, ttft_p99_ratio=2.0, ttft_p99_floor_s=0.05)
    slow = ({"n": 10, "errors": 0, "ttft": [0.200] * 10},
            {"n": 40, "errors": 0, "ttft": [0.040] * 40}, 1, 1.0)
    blip = ({"n": 10, "errors": 0, "ttft": [0.010] * 10},
            {"n": 40, "errors": 0, "ttft": [0.002] * 40}, 1, 1.0)
    got = _judged(kw, [slow, blip])
    assert got[0][:2] == (False, "ttft_p99")
    assert got[1][0] is True


# -- stub-fleet rollouts ------------------------------------------------------

def test_rollout_success_replaces_every_replica_with_drain_invariant():
    registry().reset()
    olds = [StubEngine(), StubEngine()]
    gw = Gateway(olds, tenants=[TenantConfig("t")], start=False)
    news = []

    def factory(revision):
        e = StubEngine()
        news.append((revision, e))
        return e

    ctl = RolloutController(gw, factory, gate=_quiet_gate(),
                            drain_deadline_s=1.0)
    try:
        res = ctl.rollout("r1", timeout=60)
        assert res.ok and not isinstance(res, RolloutRolledBack)
        assert res.revision == "r1" and res.upgraded == 2
        assert set(gw.router.revisions().values()) == {"r1"}
        assert len(gw.router.names) == 2
        assert all(rev == "r1" for rev, _ in news)
        assert all(e.drain_calls >= 1 and e.shut_down for e in olds)
        assert ctl.revision() == "r1" and not ctl.active()
        assert registry().get(FLEET_ROLLOUTS).value(
            {"outcome": "upgraded", "revision": "r1"}) == 1.0
        ev = {e["name"] for e in flight.events("rollout")}
        assert {"begin", "build_begin", "routed_in", "canary_passed",
                "drain_old_begin", "retired", "done"} <= ev, ev
        with pytest.raises(RolloutError):
            ctl.start_rollout("r1")
    finally:
        ctl.shutdown()
        gw.shutdown()


def test_canary_gate_bites_auto_rollback_incumbents_untouched():
    registry().reset()
    olds = [StubEngine(), StubEngine()]
    gw = Gateway(olds, tenants=[TenantConfig("t")], start=False)
    ctl = RolloutController(gw, lambda rev: StubEngine(),
                            gate=CanaryGate(min_requests=4, timeout_s=30.0),
                            drain_deadline_s=1.0)
    try:
        ctl.start_rollout("r1")
        assert _wait(lambda: (ctl.stats()["op"] or {}).get("step")
                     == "canary_gate")
        canary = next(n for n, r in gw.router.revisions().items()
                      if r == "r1")
        for _ in range(8):
            ctl.note_outcome(canary, ok=False)
            ctl.note_outcome("engine0", ok=True, ttft_s=0.01)
        res = ctl.wait(timeout=60)
        assert isinstance(res, RolloutRolledBack) and not res.ok
        assert res.gate == "error_rate" and res.upgraded == 0
        assert sorted(gw.router.names) == ["engine0", "engine1"]
        assert set(gw.router.revisions().values()) == {"r0"}
        assert all(e.drain_calls == 0 and not e.shut_down for e in olds)
        assert ctl.revision() == "r0"
        assert registry().get(FLEET_ROLLOUTS).value(
            {"outcome": "rolled_back", "revision": "r1"}) == 1.0
        ev = {e["name"] for e in flight.events("rollout")}
        assert {"rollback_begin", "rolled_back"} <= ev, ev
    finally:
        ctl.shutdown()
        gw.shutdown()


def test_canary_build_that_keeps_failing_rolls_back():
    gw = Gateway([StubEngine()], tenants=[TenantConfig("t")], start=False)

    def bad_factory(revision):
        raise RuntimeError("revision does not build")

    ctl = RolloutController(gw, bad_factory, gate=_quiet_gate(),
                            max_step_retries=2)
    try:
        res = ctl.rollout("r1", timeout=60)
        assert isinstance(res, RolloutRolledBack) and res.gate == "build"
        assert gw.router.names == ["engine0"]
        assert set(gw.router.revisions().values()) == {"r0"}
    finally:
        ctl.shutdown()
        gw.shutdown()


def test_rollout_misuse_is_typed():
    gw = Gateway([StubEngine()], tenants=[TenantConfig("t")], start=False)
    ctl = RolloutController(gw, lambda rev: StubEngine(),
                            gate=CanaryGate(min_requests=4, timeout_s=30.0))
    try:
        with pytest.raises(RolloutError):
            ctl.rollout("r0")
        ctl.start_rollout("r1")
        with pytest.raises(RolloutError):
            ctl.start_rollout("r2")
        with pytest.raises(TimeoutError):
            ctl.wait(timeout=0.05)
    finally:
        ctl.shutdown()
        gw.shutdown()
    with pytest.raises(RolloutError):
        ctl.start_rollout("r2")


@pytest.mark.parametrize("seam", ["rollout.build", "rollout.canary_gate",
                                  "rollout.drain_old"])
def test_crash_at_rollout_seam_is_absorbed_and_retried(seam):
    gw = Gateway([StubEngine(), StubEngine()],
                 tenants=[TenantConfig("t")], start=False)
    ctl = RolloutController(gw, lambda rev: StubEngine(),
                            gate=_quiet_gate(), drain_deadline_s=1.0)
    retry_ev = {"rollout.build": "build_failed",
                "rollout.canary_gate": "canary_gate_retry",
                "rollout.drain_old": "drain_old_retry"}[seam]
    try:
        faults.arm(seam, times=1)
        res = ctl.rollout("r2", timeout=60)
        assert res is not None and res.ok, res
        assert faults.hits(seam) >= 2
        assert set(gw.router.revisions().values()) == {"r2"}
        assert len(gw.router.names) == 2
        assert retry_ev in {e["name"] for e in flight.events("rollout")}
    finally:
        faults.reset()
        ctl.shutdown()
        gw.shutdown()


class _BrokenStats(StubEngine):
    """Has the compile surface, but reading it fails."""

    def compile_stats(self):
        raise RuntimeError("compile stats unreadable")


def test_decode_signature_error_is_not_swallowed():
    """A canary whose ``compile_stats`` fails is not judged as zero
    signatures: the gate records the error and re-judges; it never
    passes."""
    gw = Gateway([StubEngine()], tenants=[TenantConfig("t")], start=False)
    ctl = RolloutController(gw, lambda rev: _BrokenStats(),
                            gate=_quiet_gate(timeout_s=0.0),
                            gate_poll_s=0.01)
    try:
        ctl.start_rollout("r1")
        assert _wait(lambda: sum(
            1 for e in flight.events("rollout")
            if e["name"] == "canary_gate_retry"
            and "unreadable" in e["attrs"]["error"]) >= 2)
        assert ctl.active() and ctl.stats()["result"] is None
        assert ctl.stats()["op"]["step"] == "canary_gate"
    finally:
        ctl.shutdown()
        gw.shutdown()
    assert ctl.wait(timeout=10).gate == "shutdown"
    assert RolloutController._decode_signatures(StubEngine()) == 0


# -- autoscaler coordination --------------------------------------------------

def test_scale_down_never_victimises_rollout_replicas():
    registry().reset()
    incumbent = StubEngine()
    gw = Gateway([incumbent], tenants=[TenantConfig("t")], start=False)
    ctl = RolloutController(gw, lambda rev: StubEngine(),
                            gate=CanaryGate(min_requests=4, timeout_s=30.0))
    auto = Autoscaler(gw, StubEngine, min_replicas=1, max_replicas=4,
                      policy=_pol(), poll_interval_s=0.02,
                      drain_deadline_s=1.0, start=False)
    try:
        ctl.start_rollout("r1")
        assert _wait(lambda: "r1" in gw.router.revisions().values())
        new_name = next(n for n, r in gw.router.revisions().items()
                        if r == "r1")
        assert new_name in ctl.protected()
        assert "engine0" not in ctl.protected()
        incumbent.slots = 2
        picked = auto._pick_victim()
        assert picked is not None and picked[0] == "engine0", picked
    finally:
        ctl.shutdown()
        auto.shutdown()
        gw.shutdown()


def test_scale_up_during_rollout_builds_at_target_revision():
    registry().reset()
    gw = Gateway([StubEngine()], tenants=[TenantConfig("t")], start=False)
    gw.attach_rollout(StubRollout(revision="r9"))
    auto = Autoscaler(gw, StubEngine, min_replicas=1, max_replicas=3,
                      policy=_pol(), poll_interval_s=0.02,
                      drain_deadline_s=1.0, name_prefix="as")
    try:
        auto.trigger("up")
        assert _wait(lambda: len(gw.router.names) == 2)
        revs = gw.router.revisions()
        built = next(n for n in revs if n != "engine0")
        assert revs[built] == "r9", revs
    finally:
        auto.shutdown()
        gw.shutdown()


def test_shed_retry_after_capped_and_shrinking_during_rollout_build():
    shedder = LoadShedder()
    shedder.seed(prefill_s=5.0, token_s=1.0)
    gw = Gateway([StubEngine()], tenants=[TenantConfig("t")],
                 shedder=shedder, start=False)
    try:
        with pytest.raises(AdmissionError) as e0:
            gw.admit(_creq(deadline_ms=100), "t")
        baseline = e0.value.retry_after_s
        assert baseline > 2.0
        gw.attach_rollout(StubRollout(etas=[1.2, 0.4]))
        assert gw._fleet_pending()
        with pytest.raises(AdmissionError) as e1:
            gw.admit(_creq(deadline_ms=100), "t")
        with pytest.raises(AdmissionError) as e2:
            gw.admit(_creq(deadline_ms=100), "t")
        assert e1.value.retry_after_s <= 1.2 < baseline
        assert e2.value.retry_after_s < e1.value.retry_after_s
    finally:
        gw.shutdown()


# -- warm pool ----------------------------------------------------------------

def test_warm_pool_parks_spare_and_flash_scale_up_routes_it_in():
    registry().reset()
    gw = Gateway([StubEngine()], tenants=[TenantConfig("t")], start=False)
    auto = Autoscaler(gw, StubEngine, min_replicas=1, max_replicas=3,
                      policy=_pol(), poll_interval_s=0.02,
                      drain_deadline_s=1.0, warm_pool=1,
                      build_s_hint=7.5, name_prefix="as")
    try:
        assert _wait(lambda: len(
            auto.fleet_stats()["warm_pool"]["parked"]) == 1)
        parked = auto.fleet_stats()["warm_pool"]["parked"][0]
        assert parked["revision"] == "r0"
        spare = auto._warm[0][1]
        assert spare.draining and spare.load()["alive"] is False
        auto.trigger("up")
        assert _wait(lambda: len(gw.router.names) == 2)
        assert parked["replica"] in gw.router.names
        assert not spare.draining and spare.load()["alive"]
        up = [e for e in auto.events() if e["direction"] == "up"]
        assert up and up[-1].get("warm") is True, up
        ev = {e["name"] for e in flight.events("autoscaler")}
        assert {"warm_park", "scale_up_warm"} <= ev, ev
        assert auto.fleet_stats()["build_ewma_s"] == 7.5
        assert _wait(lambda: len(
            auto.fleet_stats()["warm_pool"]["parked"]) == 1)
    finally:
        auto.shutdown()
        gw.shutdown()


def test_warm_pool_stale_revision_spare_is_dropped_not_routed():
    registry().reset()
    gw = Gateway([StubEngine()], tenants=[TenantConfig("t")], start=False)
    auto = Autoscaler(gw, StubEngine, min_replicas=1, max_replicas=3,
                      policy=_pol(), poll_interval_s=0.02,
                      drain_deadline_s=1.0, warm_pool=1, start=False)
    stale = StubEngine()
    auto._warm.append(("as-w1", stale, "r0"))
    gw.attach_rollout(StubRollout(revision="r9"))
    try:
        assert auto._pop_warm() is None
        assert stale.shut_down
        ev = [e for e in flight.events("autoscaler")
              if e["name"] == "warm_drop"]
        assert ev and ev[-1]["attrs"]["reason"] == "stale_revision", ev
        keep, drop = StubEngine(), StubEngine()
        auto._warm = [("as-w2", keep, "r9"), ("as-w3", drop, "r0")]
        auto.drop_warm_pool(keep_revision="r9", reason="rollout")
        assert not keep.shut_down and drop.shut_down
        assert [w[0] for w in auto._warm] == ["as-w2"]
    finally:
        auto.shutdown()
        gw.shutdown()


def test_fleetsim_warm_pool_reaction_beats_cold_build():
    trace = make_trace(30.0, 4.0, seed=0, flash_mult=8.0, flash_at=0.3,
                       flash_duration_s=8.0, prompt_mean=12.0,
                       out_mean=10.0, deadline_s=3.0)
    pol_kw = dict(slo_ttft_s=1.0, up_ticks=1, idle_ticks=8,
                  cooldown_up_s=2.0, cooldown_down_s=6.0)
    sim_kw = dict(min_replicas=1, max_replicas=4, slots_per_replica=4,
                  prefill_s=0.05, token_s=0.01, build_s=1.5)

    def run(sim, pol):
        return (sim(pol(**pol_kw), **sim_kw).run(trace),
                sim(pol(**pol_kw), warm_pool=1, route_in_s=0.05,
                    **sim_kw).run(trace))

    cold, warm = run(FleetSim, ScalePolicy)
    assert (cold, warm) == run(JaxFleetSim, JaxScalePolicy)
    assert cold["warm"] is None
    w = warm["warm"]
    assert w["pool"] == 1 and w["warm_route_ins"] >= 1
    assert w["max_warm_reaction_s"] < 1.5
    assert any(e.get("warm") for e in warm["events"])
    assert warm["completed"] + warm["shed"] == warm["arrivals"]
    assert warm["replica_seconds"] > 0


# -- adapter-locality routing -------------------------------------------------

def test_pick_prefers_adapter_resident_replica_with_room():
    a, b = StubEngine(), StubEngine(resident=["lora-x"])
    router = EngineRouter([a, b], names=["a", "b"])
    b.slots = 1
    assert router.pick()[0] == "a"
    assert router.pick(adapter=None)[0] == "a"
    assert router.pick(adapter="lora-x")[0] == "b"
    assert router.pick(adapter="lora-y")[0] == "a"
    b.slots = b.max_slots
    assert router.pick(adapter="lora-x")[0] == "a"
    b.slots = 1
    assert router.pick(exclude=("b",), adapter="lora-x")[0] == "a"


def test_adapter_locality_cuts_cold_loads_on_skewed_trace():
    trace = make_trace(30.0, 6.0, seed=3, adapters=["hot", "a", "b"],
                       adapter_skew=0.8)
    assert sum(e["model"] == "hot" for e in trace) / len(trace) > 0.6

    def replay(use_hint):
        engines = [StubEngine(max_slots=4), StubEngine(max_slots=4)]
        router = EngineRouter(engines, names=["e0", "e1"])
        cold = 0
        for e in trace:
            _, eng = router.pick(adapter=e["model"] if use_hint else None)
            if e["model"] not in eng.resident:
                cold += 1
                eng.resident.append(e["model"])
                if len(eng.resident) > 2:
                    eng.resident.pop(0)
            eng.slots = (eng.slots + 1) % eng.max_slots
        return cold

    assert replay(True) < replay(False)


# -- port engines -------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(21)
    return build_gpt("gpt-tiny", device="cpu", max_position_embeddings=128)


def test_drain_on_never_warmed_engine_returns_promptly_and_undrains(tiny):
    eng = Engine(tiny, paged_kv=True, decode_kernel="pallas",
                 sample_on_device=False, max_slots=2, max_len=48)
    try:
        t0 = time.perf_counter()
        assert eng.drain(deadline_s=30.0) is True
        assert time.perf_counter() - t0 < 5.0
        assert eng.load()["draining"] and not eng.load()["alive"]
        eng.undrain()
        assert not eng.load()["draining"] and eng.load()["alive"]
        assert "undrain" in {e["name"] for e in flight.events("serving")}
    finally:
        eng.shutdown()
    with pytest.raises(EngineClosedError):
        eng.undrain()


def _jax_rollout_block():
    """The JAX gateway's ``/debug/fleet`` rollout block after a stub
    rollout."""
    gw = JaxGateway([StubEngine()], tenants=[JaxTenantConfig("t")],
                    start=False)
    ctl = JaxRolloutController(gw, lambda rev: StubEngine(),
                               gate=JaxCanaryGate(min_requests=4,
                                                  timeout_s=0.3))
    try:
        assert ctl.rollout("r1", timeout=60).ok
        return gw.fleet_stats()["rollout"]
    finally:
        ctl.shutdown()
        gw.shutdown()


def test_rollout_upgrades_real_fleet_over_http_zero_lost(tiny):
    """A live gpt-tiny replica upgraded to a new revision under HTTP
    traffic: every request completes with its full token count, the
    fleet lands all-new, the old build is torn down with no page leaked,
    every build keeps one decode signature, and the revision-labelled
    gauge, the rollout counter and ``/debug/fleet``'s rollout block (the
    JAX package's keys) report it."""
    registry().reset()
    built = []

    def factory_for_revision(revision):
        e = Engine(tiny, paged_kv=True, decode_kernel="pallas",
                   sample_on_device=False, max_slots=2, max_len=48,
                   max_queue=32)
        built.append((revision, e))
        return e

    stack = start_gateway([factory_for_revision("r0")], own_engines=True,
                          tenants=[TenantConfig("t", max_queue=64)])
    gw = stack.gateway
    ctl = RolloutController(
        stack, factory_for_revision,
        gate=CanaryGate(min_requests=2, timeout_s=30.0,
                        ttft_p99_ratio=50.0, ttft_p99_floor_s=30.0),
        drain_deadline_s=10.0, build_s_hint=2.0)
    results, lock = [], threading.Lock()

    def one(i):
        conn = http.client.HTTPConnection("127.0.0.1", stack.port,
                                          timeout=TIMEOUT)
        try:
            conn.request("POST", "/v1/completions",
                         json.dumps({"prompt": [1 + i % 7, 2, 3],
                                     "max_tokens": 4}).encode(),
                         {"Content-Type": "application/json",
                          "X-Tenant": "t"})
            r = conn.getresponse()
            body = json.loads(r.read())
        finally:
            conn.close()
        with lock:
            results.append((r.status, len(body["choices"][0]["token_ids"])
                            if r.status == 200 else 0))

    try:
        one(0)
        ctl.start_rollout("r1")
        i = 1
        while True:
            try:
                res = ctl.wait(0.05)
                break
            except TimeoutError:
                one(i)
                i += 1
                assert i < 500, "rollout never settled"
        assert res.ok and res.revision == "r1" and res.upgraded == 1
        assert results and all(s == 200 and n == 4 for s, n in results)
        assert set(gw.router.revisions().values()) == {"r1"}
        old = built[0][1]
        assert old._stop and old._page_alloc.n_used == 0
        assert all(e.compile_stats()["decode_compiles"] <= 1
                   for _, e in built)
        gw.router.loads()
        series = {dict(lbl).get("revision"): v for lbl, v in
                  registry().get(FLEET_ALIVE).series()
                  if dict(lbl).get("revision")}
        assert series.get("r1", 0) >= 1 and "r0" not in series, series
        conn = http.client.HTTPConnection("127.0.0.1", stack.port,
                                          timeout=TIMEOUT)
        conn.request("GET", "/debug/fleet")
        fleet = json.loads(conn.getresponse().read())
        conn.close()
        block = fleet["rollout"]
        assert block["revision"] == "r1" and block["result"]["ok"] is True
        assert all(row["revision"] == "r1"
                   for row in fleet["replicas"].values())
        want = _jax_rollout_block()
        assert set(block) == set(want)
        assert set(block["result"]) == set(want["result"])
        assert set(block["gate"]) == set(want["gate"])
        assert {e["event"] for e in block["events"]} == {
            e["event"] for e in want["events"]}
        conn = http.client.HTTPConnection("127.0.0.1", stack.port,
                                          timeout=TIMEOUT)
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
        conn.close()
        assert FLEET_ROLLOUTS in text and 'revision="r1"' in text
    finally:
        ctl.shutdown()
        stack.close()
        for _, e in built:
            e.shutdown()
