"""The port's supervision surface and ``EngineSupervisor``.

The port's mirror of the engine and supervisor tests of
``tests/test_self_healing.py`` (death classification, the crash matrix over
the same seams, the redispatch hook, restart with the same handles, no
replay of streamed requests, the stall watchdog, the restart budget, a fault
inside the rebuild, drain), on the port's ``Engine(paged_kv=True,
decode_kernel="pallas")`` on a CPU model with gpt-tiny weights loaded from
the JAX model; the flight-recorder checks of the JAX tests become counter
checks (the recorder belongs to the observability module). Then the handles
a supervisor re-dispatches must give the JAX package's greedy tokens for the
same prompts. Every wait is bounded.
"""
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import paddle_tpu as paddle
from paddle_tpu.models import build_gpt as jax_build_gpt
from paddle_tpu.models import gpt_config as jax_gpt_config
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import EngineSupervisor as JaxSupervisor
from paddle_tpu.testing import faults as jax_faults

from paddle_tpu_torch.models import build_gpt, load_jax_state
from paddle_tpu_torch.serving import (Engine, EngineDeadError,
                                      EngineDrainingError,
                                      EngineStalledError, EngineSupervisor,
                                      QueueFullError,
                                      RequestInterruptedError)
from paddle_tpu_torch.testing import faults

torch.set_num_threads(1)

TIMEOUT = 120


@pytest.fixture(scope="module")
def models():
    cfg = jax_gpt_config("gpt-tiny", max_position_embeddings=128,
                         hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    paddle.seed(11)
    jm = jax_build_gpt(cfg)
    jm.eval()
    pm = build_gpt("gpt-tiny", device="cpu", max_position_embeddings=128)
    load_jax_state(pm, {k: np.asarray(v._value)
                        for k, v in jm.state_dict().items()})
    return jm, pm


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    jax_faults.reset()
    yield
    faults.reset()
    jax_faults.reset()


def _engine(pm, **kw):
    return Engine(pm, paged_kv=True, decode_kernel="pallas",
                  sample_on_device=False, page_size=8, **kw)


def _wait(pred, timeout=60.0, period=0.01):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if pred():
            return True
        time.sleep(period)
    return False


def _healed(sup, prompt):
    def check():
        try:
            return len(sup.submit(prompt, max_new_tokens=2).result(
                timeout=TIMEOUT)) == 2
        except (QueueFullError, EngineDeadError):
            return False
    return check


# -- engine death classification ----------------------------------------------

def test_death_classifies_streamed_vs_zero_token(models):
    _, pm = models
    eng = _engine(pm, max_slots=1, max_len=32, auto_start=False)
    try:
        h_active = eng.submit([1, 2, 3], max_new_tokens=4)
        h_queued = eng.submit([4, 5], max_new_tokens=4)
        faults.arm("serving.decode", exc=RuntimeError("chip fell over"),
                   times=1)
        eng.start()
        err_a = h_active.exception(timeout=TIMEOUT)
        err_q = h_queued.exception(timeout=TIMEOUT)
        assert isinstance(err_a, RequestInterruptedError)
        assert err_a.tokens_streamed == len(h_active.tokens) >= 1
        assert err_a.request_id == h_active.request_id
        assert isinstance(err_a.cause, RuntimeError)
        assert isinstance(err_q, EngineDeadError)
        assert not h_queued.tokens
        st = eng.stats()
        assert st["interrupted"] == 1 and st["failed"] == 2
        assert eng.health()["dead"]
        with pytest.raises(EngineDeadError):
            eng.submit([1], max_new_tokens=1)
    finally:
        eng.shutdown()


@pytest.mark.parametrize("seam,err_type", [
    ("serving.prefill", EngineDeadError),
    ("serving.stream", EngineDeadError),      # before the first emit
    ("serving.decode", RequestInterruptedError),
])
def test_crash_matrix_serving_seams(models, seam, err_type):
    _, pm = models
    eng = _engine(pm, max_slots=2, max_len=32, auto_start=False)
    try:
        h = eng.submit([3, 1, 4], max_new_tokens=3)
        faults.arm(seam, times=1)
        eng.start()
        err = h.exception(timeout=TIMEOUT)
        assert isinstance(err, err_type), (seam, err)
        if err_type is EngineDeadError:
            assert not h.tokens, "zero-token classification must hold"
        assert isinstance(err.cause, faults.FaultInjected)
        assert err.cause.point == seam
        assert eng.health()["dead"]
        assert faults.hits(seam) >= 1
    finally:
        eng.shutdown()
    st = eng.stats()
    assert st["kv_pages_used"] == 0 and st["active_slots"] == 0


def test_redispatch_hook_takes_zero_token_requests(models):
    _, pm = models
    parked = []
    eng = _engine(pm, max_slots=2, max_len=32, auto_start=False,
                  redispatch_hook=lambda reqs, cause: parked.extend(reqs)
                  or reqs)
    eng2 = None
    try:
        h1 = eng.submit([1, 2, 3], max_new_tokens=3)
        h2 = eng.submit([4, 5], max_new_tokens=3)
        faults.arm("serving.prefill", times=1)
        eng.start()
        assert _wait(lambda: eng.health()["dead"], TIMEOUT)
        assert {r.request_id for r in parked} == {h1.request_id,
                                                 h2.request_id}
        assert not h1.done() and not h2.done()
        faults.reset()
        eng2 = _engine(pm, max_slots=2, max_len=32)
        for r in parked:
            eng2.resubmit(r)
        a, b = h1.result(timeout=TIMEOUT), h2.result(timeout=TIMEOUT)
        assert len(a) == 3 and len(b) == 3
        assert h1.redispatches == 1
        assert eng2.stats()["resubmitted"] == 2
        assert eng.stats()["redispatched"] == 2
        h3 = eng2.submit([7, 8], max_new_tokens=2)
        h3.result(timeout=TIMEOUT)
        with pytest.raises(ValueError, match="already streamed"):
            eng2.resubmit(h3)
    finally:
        eng.shutdown()
        if eng2 is not None:
            eng2.shutdown()


# -- supervisor ---------------------------------------------------------------

def _sub(sup, prompt, **kw):
    # a submit may land between the death and the rebuild (backpressure)
    deadline = time.perf_counter() + TIMEOUT
    while True:
        try:
            return sup.submit(prompt, max_new_tokens=3, **kw)
        except QueueFullError:
            assert time.perf_counter() < deadline
            time.sleep(0.02)


def test_supervisor_restart_redispatches_same_handles(models):
    _, pm = models
    sup = EngineSupervisor(lambda: _engine(pm, max_slots=2, max_len=32),
                           name="sup0", poll_interval_s=0.02)
    try:
        faults.arm("serving.prefill", times=1)
        handles = [_sub(sup, [i + 1, i + 2]) for i in range(3)]
        results = [h.result(timeout=TIMEOUT) for h in handles]
        assert all(len(r) == 3 for r in results)
        assert sup.restarts == 1
        assert sup.redispatched >= 1
        assert any(h.redispatches == 1 for h in handles)
        builds = sup.builds()
        assert builds[-1]["decode_compiles"] == 1
        assert all(b["decode_compiles"] <= 1 for b in builds)
        assert len(sup.submit([9, 9], max_new_tokens=2
                              ).result(timeout=TIMEOUT)) == 2
    finally:
        sup.shutdown()


def test_supervisor_never_replays_streamed_requests(models):
    _, pm = models
    seen = []
    sup = EngineSupervisor(lambda: _engine(pm, max_slots=2, max_len=64),
                           name="sup1", poll_interval_s=0.02)
    try:
        # prefill + 3 decode crossings through, then the kill: exactly 4
        # tokens streamed
        faults.arm("serving.decode", times=1, after=3)
        h = sup.submit([2, 7, 1], max_new_tokens=12, stream=seen.append)
        err = h.exception(timeout=TIMEOUT)
        assert isinstance(err, RequestInterruptedError)
        assert err.tokens_streamed == len(seen) == len(h.tokens) == 4
        assert h.redispatches == 0
        faults.reset()
        assert _wait(_healed(sup, [5, 5]), TIMEOUT, period=0.1)
        assert sup.restarts == 1
    finally:
        sup.shutdown()


def test_supervisor_stall_watchdog_abandons_and_rebuilds(models):
    """A stalled decode: the supervisor sees the frozen heartbeat,
    abandons the engine (EngineStalledError) and rebuilds; the stalled
    request is interrupted, new work completes on the fresh build, and
    the abandoned thread exits without another launch."""
    _, pm = models
    built = []

    def factory():
        e = _engine(pm, max_slots=2, max_len=32)
        built.append(e)
        return e

    sup = EngineSupervisor(factory, name="sup2", poll_interval_s=0.02)
    try:
        sup.submit([1, 2], max_new_tokens=2).result(timeout=TIMEOUT)
        sup.stall_timeout_s = 0.4
        faults.arm("serving.decode", mode="delay", seconds=2.5, times=1)
        h = sup.submit([3, 4, 5], max_new_tokens=6)
        err = h.exception(timeout=TIMEOUT)
        assert isinstance(err, RequestInterruptedError)
        assert isinstance(err.cause, EngineStalledError)
        assert _wait(lambda: sup.restarts >= 1, TIMEOUT, period=0.05)
        assert _wait(_healed(sup, [6, 6]), TIMEOUT, period=0.1)
        old = built[0]
        old._thread.join(timeout=TIMEOUT)
        assert not old._thread.is_alive()
        assert old.stats()["decode_steps"] == 1    # none after the stall
    finally:
        sup.shutdown()


def test_supervisor_gives_up_past_restart_budget(models):
    _, pm = models
    sup = EngineSupervisor(lambda: _engine(pm, max_slots=1, max_len=32),
                           name="sup3", poll_interval_s=0.01,
                           max_restarts=2, restart_window_s=60.0)
    try:
        faults.arm("serving.scheduler", times=None)   # every build dies
        h = sup.submit([1, 2], max_new_tokens=2)
        err = h.exception(timeout=TIMEOUT)
        assert isinstance(err, EngineDeadError)
        assert _wait(lambda: sup.failed is not None, TIMEOUT)
        assert sup.restarts <= 2
        assert sup.load()["alive"] is False
        assert sup.health()["alive"] is False
        faults.reset()
        with pytest.raises(EngineDeadError):
            sup.submit([1], max_new_tokens=1)
    finally:
        sup.shutdown()


def test_supervisor_rebuild_fault_is_retried(models):
    _, pm = models
    sup = EngineSupervisor(lambda: _engine(pm, max_slots=1, max_len=32),
                           name="sup4", poll_interval_s=0.02,
                           max_restarts=3)
    try:
        faults.arm("serving.scheduler", times=1)
        faults.arm("serving.rebuild", times=1)
        h = sup.submit([1, 2], max_new_tokens=2)
        assert len(h.result(timeout=TIMEOUT)) == 2
        assert h.redispatches == 1
        assert faults.hits("serving.rebuild") >= 2   # failed, then rebuilt
        assert sup.restarts == 1
    finally:
        sup.shutdown()


# -- graceful drain -----------------------------------------------------------

def test_engine_drain_completes_inflight_then_rejects(models):
    _, pm = models
    # the queue holds all five whether or not the scheduler admitted any
    eng = _engine(pm, max_slots=2, max_len=48, max_queue=5)
    try:
        handles = [eng.submit([i + 1] * 3, max_new_tokens=5)
                   for i in range(5)]
        assert eng.drain(deadline_s=TIMEOUT) is True
        for h in handles:
            assert len(h.result(timeout=1)) == 5
        ld = eng.load()
        assert ld["alive"] is False and ld["draining"] is True
        with pytest.raises(EngineDrainingError):
            eng.submit([1], max_new_tokens=1)
        assert eng.stats()["completed"] == 5
        eng.undrain()
        assert eng.load()["alive"] is True
        assert eng.queue_depth() == 0 and eng.slots_in_use() == 0
    finally:
        eng.shutdown()


# -- the port against the JAX package -----------------------------------------

def test_redispatched_tokens_match_jax(models):
    """The same prompts through a supervisor on each package, the first
    prefill killed: every handle completes after the rebuild, and the
    re-dispatched handles' greedy tokens are the JAX package's."""
    jm, pm = models
    prompts = [np.arange(3, 3 + n) % 1024 for n in (5, 9, 4)]
    kw = dict(max_slots=2, max_len=32, page_size=8)
    out = {}
    for side, sup_cls, flt in (
            ("jax", JaxSupervisor, jax_faults),
            ("port", EngineSupervisor, faults)):
        if side == "jax":
            def factory():
                return JaxEngine(jm, paged_kv=True, decode_kernel="pallas",
                                 **kw)
        else:
            def factory():
                return Engine(pm, paged_kv=True, decode_kernel="pallas",
                              sample_on_device=False, **kw)
        sup = sup_cls(factory, name=f"parity-{side}", poll_interval_s=0.02)
        try:
            flt.arm("serving.prefill", times=1)
            handles = [_sub(sup, p) for p in prompts]
            out[side] = ([h.result(timeout=300) for h in handles],
                         [h.redispatches for h in handles])
            assert sup.restarts == 1
        finally:
            flt.reset()
            sup.shutdown()
    (want, jre), (got, pre) = out["jax"], out["port"]
    assert any(pre)
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
