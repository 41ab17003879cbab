"""The port's HTTP gateway against the JAX package's, on gpt-tiny.

The plain-Python layers are held to the JAX package's on the same inputs:
the protocol (parsed fields, or the same ``ProtocolError`` text and
status), admission (the dispatch order of the same arrivals: fair share,
weights, the idle reset, strict priorities, caps), and the shedder (the
same decisions and ``Retry-After``).  Then a JAX gateway over
``Engine(paged_kv=True, page_size=8, decode_kernel="pallas")`` (interpret
mode on the CPU) and a port gateway over ``Engine(device="cpu")`` with the
same weights, each on port 0, take the same requests: greedy token ids
are equal bitwise, whole and streamed; the SSE chunk bodies are equal
once ids and timestamps are masked; sheds carry the same status, body and
``Retry-After``; ``/healthz`` has the same keys; and ``/metrics`` the same
families after the same traffic.  Then supervision and routing on the
port: failover away from an engine killed through ``faults``, the journey
id kept across a supervisor rebuild and across a cross-replica
re-dispatch, the ``decode_timeout_s`` watchdog, ``model=`` routing to a
LoRA adapter, and a clean shutdown.  Every wait is bounded.
"""
import http.client
import json
import os
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import paddle_tpu as paddle
from paddle_tpu import observability as jax_obs
from paddle_tpu.models import build_gpt as jax_build_gpt
from paddle_tpu.models import gpt_config as jax_gpt_config
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import gateway as jax_gw
from paddle_tpu.testing import faults as jax_faults

from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.models import build_gpt, load_jax_state
from paddle_tpu_torch.observability import watchdog
from paddle_tpu_torch.serving import (AdapterRegistry, Engine,
                                      EngineSupervisor, make_lora,
                                      merge_into_qkv)
from paddle_tpu_torch.serving import gateway as gw
from paddle_tpu_torch.testing import faults

torch.set_num_threads(1)

TIMEOUT = 120
# the families a gateway's /metrics is compared over (the JAX registry
# also holds other layers' series: compile counters, the op layer)
FAMILIES = ("paddle_tpu_serving_", "paddle_tpu_gateway_",
            "paddle_tpu_journey_", "paddle_tpu_capture_", "paddle_tpu_fleet_")


@pytest.fixture(scope="module")
def models():
    cfg = jax_gpt_config("gpt-tiny", max_position_embeddings=128,
                         hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    paddle.seed(7)
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


ENGINE_KW = dict(max_slots=2, max_len=64, paged_kv=True, page_size=8,
                 max_queue=16)


@pytest.fixture(scope="module")
def stacks(models):
    """A JAX gateway and a port gateway over the same weights."""
    jm, pm = models
    jstack = jax_gw.start_gateway(
        [JaxEngine(jm, decode_kernel="pallas", **ENGINE_KW)],
        own_engines=True)
    pstack = gw.start_gateway([Engine(pm, device="cpu", **ENGINE_KW)],
                              own_engines=True)
    yield jstack, pstack
    pstack.close()
    jstack.close()


def _post(port, payload, headers=None, path="/v1/completions"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        hdrs = {"Content-Type": "application/json"}
        hdrs.update(headers or {})
        conn.request("POST", path, json.dumps(payload).encode(), hdrs)
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _sse(raw):
    """SSE ``data:`` payloads of a streamed body, ``[DONE]`` last."""
    out = []
    for block in raw.split(b"\n\n"):
        if block.startswith(b"data: "):
            data = block[6:]
            out.append(data if data == b"[DONE]" else json.loads(data))
    return out


def _masked(body):
    """A response body with the per-package ids and timestamps masked."""
    body = dict(body)
    for k in ("id", "created", "request_id"):
        body.pop(k, None)
    return body


def _wait(pred, timeout=60.0):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


# -- protocol ------------------------------------------------------------------

BODIES = [
    {"prompt": [1, 2, 3], "max_tokens": 4, "temperature": 0.5, "top_k": 8,
     "seed": 3, "stream": True, "stop": 7, "deadline_ms": 250,
     "priority": "interactive", "model": "m", "some_future_field": 1},
    {"prompt": [5], "stop": [9], "conversation": "c-1"},
    {"prompt": "hi"}, {}, {"prompt": []}, {"prompt": [1, -2]},
    {"prompt": [1, True]}, {"prompt": 3},
    {"prompt": [1], "max_tokens": 0}, {"prompt": [1], "max_tokens": "4"},
    {"prompt": [1], "max_tokens": True},
    {"prompt": [1], "temperature": -1}, {"prompt": [1], "priority": "vip"},
    {"prompt": [1], "stop": "end"}, {"prompt": [1], "stop": 1.5},
    {"prompt": [1], "deadline_ms": 0}, {"prompt": [1], "conversation": ""},
    {"prompt": [1], "stream": 1},
]
RAW_BODIES = [b"{not json", b"[1, 2]", b"\xff\xfe", b"x" * ((1 << 20) + 1)]
CHAT_BODIES = [
    {"messages": [{"role": "user", "content": [1, 2]},
                  {"role": "assistant", "content": [3]}],
     "max_tokens": 3, "conversation": "c"},
    {"messages": [{"role": "user", "content": "hello"}]},
    {"messages": []}, {"messages": [{"content": [1]}]},
    {"messages": [{"role": "user", "content": []}]},
    {"messages": [{"role": "user", "content": [1]},
                  {"role": "user", "content": "x"}]},
]


def _parse(mod, parse, raw, tokenizer):
    try:
        r = getattr(mod, parse)(raw, has_tokenizer=tokenizer)
    except mod.ProtocolError as e:
        return ("error", e.status, str(e), e.body())
    return ("ok",) + tuple(getattr(r, k) for k in type(r).__slots__)


@pytest.mark.parametrize("tokenizer", [False, True])
@pytest.mark.parametrize("case", range(len(BODIES) + len(RAW_BODIES)
                                       + len(CHAT_BODIES)))
def test_protocol_parse_matches_jax(case, tokenizer):
    n_body, n_raw = len(BODIES), len(RAW_BODIES)
    if case < n_body:
        raw, parse = json.dumps(BODIES[case]).encode(), \
            "parse_completion_request"
    elif case < n_body + n_raw:
        raw, parse = RAW_BODIES[case - n_body], "parse_completion_request"
    else:
        raw = json.dumps(CHAT_BODIES[case - n_body - n_raw]).encode()
        parse = "parse_chat_request"
    want = _parse(jax_gw.protocol, parse, raw, tokenizer)
    got = _parse(gw.protocol, parse, raw, tokenizer)
    assert got == want


@pytest.mark.parametrize("headers,keys", [
    ({"Authorization": "Bearer alice"}, None), ({"X-Tenant": "bob"}, None),
    ({"X-Api-Key": "k1"}, None), ({}, None),
    ({"Authorization": "Bearer sk-1"}, {"sk-1": "alice"}),
    ({"Authorization": "Bearer nope"}, {"sk-1": "alice"}),
    ({}, {"sk-1": "alice"})])
def test_tenant_from_headers_matches_jax(headers, keys):
    def run(mod):
        try:
            return mod.tenant_from_headers(headers, keys)
        except mod.ProtocolError as e:
            return (e.status, str(e), e.body())
    assert run(gw.protocol) == run(jax_gw.protocol)


def test_response_bodies_match_jax():
    p, j = gw.protocol, jax_gw.protocol
    cases = [("completion_body", ("c1", "m", "t", [1, 2], "stop", 3)),
             ("chunk_body", ("c1", "m", "t", [4], None)),
             ("chat_completion_body", ("c1", "m", "t", [1], "length", 2)),
             ("chat_chunk_body", ("c1", "m", "", [], "stop"))]
    for name, args in cases:
        for kw in ({}, {"request_id": "r-1"}):
            assert _masked(getattr(p, name)(*args, **kw)) == \
                _masked(getattr(j, name)(*args, **kw))
    assert p.sse_event({"a": 1}) == j.sse_event({"a": 1})
    assert p.SSE_DONE == j.SSE_DONE and p.PRIORITIES == j.PRIORITIES
    assert p.error_body("x", code="c") == j.error_body("x", code="c")


# -- admission and shedding ----------------------------------------------------

class _Item:
    def __init__(self, tenant, cost=10.0, priority="standard", tag=None):
        self.tenant = tenant
        self.cost = float(cost)
        self.priority = priority
        self.tag = tag


def _equal_weights(m):
    s = m.FairShareScheduler([m.TenantConfig("a"), m.TenantConfig("b")])
    for i in range(4):
        s.enqueue(_Item("a", tag=f"a{i}"))
    for i in range(2):
        s.enqueue(_Item("b", tag=f"b{i}"))
    return [s.pop(timeout=1).tag for _ in range(6)]


def _weights_and_idle_reset(m):
    s = m.FairShareScheduler([m.TenantConfig("heavy", weight=3.0),
                              m.TenantConfig("light", weight=1.0)])
    for i in range(6):
        s.enqueue(_Item("heavy", cost=12, tag=f"h{i}"))
    for i in range(2):
        s.enqueue(_Item("light", cost=12, tag=f"l{i}"))
    order = [s.pop(timeout=1).tag for _ in range(6)]
    while s.depth():
        order.append(s.pop(timeout=1).tag)
    s.enqueue(_Item("heavy", cost=12, tag="h-late"))
    s.enqueue(_Item("late", cost=12, tag="late"))
    order += [s.pop(timeout=1).tag for _ in range(2)]
    return order, s.depths()


def _priorities(m):
    s = m.FairShareScheduler()
    s.enqueue(_Item("bulk", priority="batch", tag="b0"))
    s.enqueue(_Item("bulk2", priority="standard", tag="s0"))
    s.enqueue(_Item("vip", priority="interactive", tag="i0"))
    s.enqueue(_Item("bulk", priority="interactive", tag="b1"))
    return [s.pop(timeout=1).tag for _ in range(4)]


def _caps(m):
    s = m.FairShareScheduler([m.TenantConfig("t", max_queue=2,
                                             max_concurrency=1)],
                             max_queue_total=3)
    out = []
    s.enqueue(_Item("t", tag=0))
    s.enqueue(_Item("t", tag=1))
    for item in (_Item("t", tag=2), _Item("u", tag=3), _Item("v", tag=4)):
        try:
            s.enqueue(item)
            out.append(("queued", item.tag))
        except m.AdmissionError as e:
            out.append((e.reason, str(e), e.retry_after_s, e.status))
    first = s.pop(timeout=1)
    out.append(first.tag)
    out.append(s.pop(timeout=0.05).tag)     # t is at its cap: u runs
    s.release("t", first.cost)
    it = s.pop(timeout=1)
    s.requeue(it)
    out.append(s.pop(timeout=1).tag)
    out.append(s.backlog_cost("standard"))
    out.append(s.depths())
    return out


ADMISSION = [_equal_weights, _weights_and_idle_reset, _priorities, _caps]


@pytest.mark.parametrize("scenario", ADMISSION,
                         ids=[f.__name__.strip("_") for f in ADMISSION])
def test_admission_order_matches_jax(scenario):
    assert scenario(gw) == scenario(jax_gw)


def _shed_run(m, seed):
    rs = np.random.RandomState(seed)
    sh = m.LoadShedder(alpha=0.3, margin=1.2)
    out = [vars_of(sh.decide(0.01, 1e6, 4))]       # cold start admits
    sh.seed(prefill_s=rs.uniform(0.01, 0.2), token_s=rs.uniform(1e-3, 0.02))
    for _ in range(20):
        if rs.uniform() < 0.5:
            sh.observe_prefill(rs.uniform(0.0, 0.3))
        else:
            sh.observe_tokens(list(rs.uniform(0.0, 0.03, 4)))
        out.append(vars_of(sh.decide(
            float(rs.choice([0.05, 0.2, 1.0])), float(rs.randint(0, 800)),
            int(rs.randint(1, 9)))))
    out.append(sh.snapshot())
    out.append(sh.estimate_ttft(100, 4))
    return out


def vars_of(d):
    return (d.admit, d.est_ttft_s, d.retry_after_s, d.reason)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shedder_decisions_match_jax(seed):
    assert _shed_run(gw, seed) == _shed_run(jax_gw, seed)
    with pytest.raises(ValueError, match="alpha"):
        gw.LoadShedder(alpha=0.0)


# -- HTTP end to end against the JAX gateway -----------------------------------

PROMPTS = [[5, 17, 3, 8], [9, 2, 7], [100, 200, 300, 400, 500],
           [1, 1, 2, 3, 5, 8]]


@pytest.mark.parametrize("stream", [False, True], ids=["whole", "stream"])
def test_http_greedy_tokens_match_jax(stacks, stream):
    jstack, pstack = stacks
    for prompt in PROMPTS:
        body = {"prompt": prompt, "max_tokens": 6, "stream": stream}
        js, jh, jraw = _post(jstack.port, body)
        ps, ph, praw = _post(pstack.port, body)
        assert js == ps == 200
        assert ph["X-Request-Id"] and ph["X-Paddle-Tpu-Engine"] == "engine0"
        if not stream:
            jb, pb = json.loads(jraw), json.loads(praw)
            assert pb["choices"][0]["token_ids"] == \
                jb["choices"][0]["token_ids"]
            assert len(pb["choices"][0]["token_ids"]) == 6
            assert _masked(pb) == _masked(jb)
            assert pb["request_id"] == ph["X-Request-Id"]
            continue
        assert ph["Content-Type"] == jh["Content-Type"] == \
            "text/event-stream"
        assert ph["Transfer-Encoding"] == "chunked"
        jev, pev = _sse(jraw), _sse(praw)
        assert pev[-1] == jev[-1] == b"[DONE]"
        assert [_masked(e) for e in pev[:-1]] == \
            [_masked(e) for e in jev[:-1]]
        assert pev[-2]["request_id"] == ph["X-Request-Id"]
        assert sum(len(e["choices"][0]["token_ids"]) for e in pev[:-1]) == 6
    eng = pstack.gateway.router.engines[0]
    assert eng.compile_stats()["decode_compiles"] == 1, \
        "gateway traffic must keep ONE decode signature"


def test_http_errors_and_chat_match_jax(stacks):
    jstack, pstack = stacks
    for body, path in [({"prompt": "text"}, "/v1/completions"),
                       ({"prompt": [1, 2], "max_tokens": 1000},
                        "/v1/completions"),
                       ({"prompt": [1], "model": "nope"}, "/v1/completions"),
                       ({"prompt": [1]}, "/v1/nothing"),
                       ({"messages": [{"role": "user", "content": [4, 5]}],
                         "max_tokens": 3, "conversation": "c-9"},
                        "/v1/chat/completions")]:
        js, _, jraw = _post(jstack.port, body, path=path)
        ps, _, praw = _post(pstack.port, body, path=path)
        assert ps == js, (body, praw, jraw)
        assert _masked(json.loads(praw)) == _masked(json.loads(jraw))
    for path in ("/nope", "/debug/slo", "/debug/incidents",
                 "/debug/incidents/x", "/debug/requests/absent-id"):
        (js, jraw), (ps, praw) = _get(jstack.port, path), \
            _get(pstack.port, path)
        assert ps == js == 404
        assert json.loads(praw)["error"]["code"] == \
            json.loads(jraw)["error"]["code"]
    (js, jraw), (ps, praw) = _get(jstack.port, "/healthz"), \
        _get(pstack.port, "/healthz")
    jh, ph = json.loads(jraw), json.loads(praw)
    assert ps == js == 200 and ph["alive"]
    assert set(ph) == set(jh)
    assert set(ph["engines"]["engine0"]) == set(jh["engines"]["engine0"])
    for path in ("/debug/window", "/debug/fleet", "/debug/capture?last=2",
                 "/debug/perf", "/debug/memory", "/debug/requests?last=2"):
        (js, jraw), (ps, praw) = _get(jstack.port, path), \
            _get(pstack.port, path)
        assert ps == js == 200, path
        assert set(json.loads(praw)) <= set(json.loads(jraw)) | {
            "dtype", "peak_flops"}, path


def _families(port):
    status, raw = _get(port, "/metrics")
    assert status == 200
    return {ln.split()[2] for ln in raw.decode().splitlines()
            if ln.startswith("# TYPE") and ln.split()[2].startswith(FAMILIES)}


def test_metrics_families_match_jax(stacks):
    jstack, pstack = stacks
    jax_obs.registry().reset()
    obs.registry().reset()
    for stack in stacks:
        for body in ({"prompt": [3, 4, 5], "max_tokens": 3},
                     {"prompt": [6, 7], "max_tokens": 2, "stream": True},
                     {"prompt": [1], "priority": "vip"}):
            _post(stack.port, body, headers={"X-Tenant": "t1"})
        _get(stack.port, "/healthz")
    want, got = _families(jstack.port), _families(pstack.port)
    assert got == want
    assert "paddle_tpu_serving_tokens_total" in got
    assert "paddle_tpu_gateway_window_ttft_seconds" in got


def _shed_pair(models, tenant_cap):
    """Two gateways, dispatchers off, latency model seeded: a queued
    backlog the shed formula sees."""
    jm, pm = models
    out = []
    for mod, eng in ((jax_gw, JaxEngine(jm, decode_kernel="pallas",
                                        auto_start=False, **ENGINE_KW)),
                     (gw, Engine(pm, device="cpu", auto_start=False,
                                 **ENGINE_KW))):
        shedder = mod.LoadShedder()
        shedder.seed(prefill_s=0.05, token_s=0.01)
        g = mod.Gateway([eng], tenants=[mod.TenantConfig(
            "bulk", max_queue=tenant_cap)], shedder=shedder, start=False)
        creq = mod.parse_completion_request(
            json.dumps({"prompt": [1] * 4, "max_tokens": 20}).encode(),
            has_tokenizer=False)
        for _ in range(tenant_cap):
            g.admit(creq, "bulk")
        out.append((mod.start_gateway(g), eng))
    return out


def test_shed_429_and_retry_after_match_jax(models):
    pair = _shed_pair(models, 10)
    try:
        results = []
        for stack, _ in pair:
            rows = []
            for body, tenant in (
                    ({"prompt": [1] * 4, "max_tokens": 20,
                      "deadline_ms": 200}, "vip"),
                    ({"prompt": [1] * 4, "max_tokens": 20}, "bulk")):
                status, headers, raw = _post(stack.port, body,
                                             headers={"X-Tenant": tenant})
                rows.append((status, headers.get("Retry-After"),
                             json.loads(raw)))
            results.append(rows)
        assert results[1] == results[0]
        (s1, ra1, b1), (s2, ra2, b2) = results[1]
        assert s1 == s2 == 429 and int(ra1) >= 1 and int(ra2) >= 1
        assert b1["error"]["code"] == "slo_shed"
        assert b2["error"]["code"] == "tenant_queue_full"
        assert pair[1][1].stats()["submitted"] == 0
    finally:
        for stack, eng in pair:
            stack.close()
            eng.shutdown()


# -- supervision and routing on the port ---------------------------------------

def _engine(pm, **kw):
    return Engine(pm, device="cpu", page_size=8, max_len=64, **kw)


def test_router_failover_away_from_dead_engine(models):
    _, pm = models
    eng_a, eng_b = _engine(pm, max_slots=2), _engine(pm, max_slots=2)
    faults.arm("serving.scheduler", exc=RuntimeError("pool exploded"),
               times=None)
    try:
        h = eng_a.submit([1, 2, 3], max_new_tokens=2)
        assert h.exception(timeout=TIMEOUT) is not None
    finally:
        faults.reset()
    assert eng_a.health()["dead"] and not eng_b.health()["dead"]
    with gw.start_gateway([eng_a, eng_b], own_engines=True,
                          names=["a", "b"]) as stack:
        for i in range(3):
            status, headers, raw = _post(
                stack.port, {"prompt": [4 + i, 9], "max_tokens": 2})
            assert status == 200, raw
            assert headers["X-Paddle-Tpu-Engine"] == "b"
        status, raw = _get(stack.port, "/healthz")
        health = json.loads(raw)
        assert status == 200 and health["alive"]
        assert health["engines"]["a"]["alive"] is False
        assert health["engines"]["b"]["alive"] is True
        assert eng_b.compile_stats()["decode_compiles"] == 1
    # with every replica dead the gateway answers 503
    eng_c = _engine(pm, max_slots=1, auto_start=False)
    eng_c.shutdown()
    with gw.start_gateway([eng_c], names=["c"]) as stack:
        status, _, raw = _post(stack.port, {"prompt": [1], "max_tokens": 1})
        assert status == 503
        status, raw = _get(stack.port, "/healthz")
        assert status == 503 and not json.loads(raw)["alive"]


def _phases(port, jid):
    status, raw = _get(port, f"/debug/requests/{jid}")
    assert status == 200, raw
    tl = json.loads(raw)
    total = sum(p["dur_ms"] for p in tl["phases"])
    assert abs(total - tl["wall_ms"]) < 0.05, tl     # rounding of the ms
    return tl


def test_journey_kept_across_cross_replica_redispatch(models):
    """engine0's prefill dies with the request's zero tokens: the gateway
    re-dispatches it to engine1 on the SAME journey id."""
    _, pm = models
    a, b = _engine(pm, max_slots=2), _engine(pm, max_slots=2)
    ref = _engine(pm, max_slots=2)
    want = ref.submit([7, 8, 9], max_new_tokens=4).result(timeout=TIMEOUT)
    ref.shutdown()
    with gw.start_gateway([a, b], own_engines=True) as stack:
        faults.arm("serving.prefill", exc=RuntimeError("prefill died"),
                   times=1)
        status, headers, raw = _post(
            stack.port, {"prompt": [7, 8, 9], "max_tokens": 4},
            headers={"X-Request-Id": "hop-1"})
        assert status == 200, raw
        assert headers["X-Request-Id"] == "hop-1"
        assert headers["X-Paddle-Tpu-Engine"] == "engine1"
        assert json.loads(raw)["choices"][0]["token_ids"] == \
            [int(t) for t in want]
        tl = _phases(stack.port, "hop-1")
        names = [p["phase"] for p in tl["phases"]]
        assert "redispatch" in names and names.count("prefill") == 1
        assert tl["attrs"]["redispatches"] == 1
        assert a.health()["dead"]


def test_journey_kept_across_supervisor_rebuild(models):
    _, pm = models
    sup = EngineSupervisor(lambda: _engine(pm, max_slots=2), name="sup",
                           poll_interval_s=0.005)
    with gw.start_gateway([sup], own_engines=True) as stack:
        _post(stack.port, {"prompt": [2, 3], "max_tokens": 2})   # warm
        faults.arm("serving.prefill", exc=RuntimeError("prefill died"),
                   times=1)
        status, headers, raw = _post(
            stack.port, {"prompt": [4, 5, 6], "max_tokens": 3},
            headers={"X-Request-Id": "kept"})
        assert status == 200, raw
        assert sup.restarts == 1
        tl = _phases(stack.port, "kept")
        rebuild = [p for p in tl["phases"] if p["phase"] == "rebuild"]
        assert len(rebuild) == 1 and rebuild[0]["attrs"]["restart"] == 1
        assert rebuild[0]["attrs"]["engine"] == "sup"
        names = [p["phase"] for p in tl["phases"]]
        assert names.index("rebuild") < names.index("prefill")
        assert len(json.loads(raw)["choices"][0]["token_ids"]) == 3
        assert all(b["decode_compiles"] == 1 for b in sup.builds())
        m = obs.registry().get(
            "paddle_tpu_serving_engine_restarts_total")
        assert m is not None and m.value({"engine": "sup"}) >= 1


def test_decode_timeout_watchdog_dumps_on_stalled_decode(models, tmp_path,
                                                         monkeypatch):
    """A seam stalls the decode step past ``decode_timeout_s``: the
    watchdog writes its bundle while the scheduler is still stuck, and
    the request finishes all the same."""
    _, pm = models
    monkeypatch.setenv("PADDLE_TPU_DUMP_DIR", str(tmp_path))
    fired0 = watchdog._watchdog.fired_count
    eng = _engine(pm, max_slots=1, decode_timeout_s=0.05)
    try:
        faults.arm("serving.decode", mode="delay", seconds=1.5, times=1)
        h = eng.submit([1, 2, 3], max_new_tokens=3)
        assert _wait(lambda: watchdog._watchdog.fired_count > fired0)
        assert not h.done(), "the bundle must be written mid-stall"
        assert len(h.result(timeout=TIMEOUT)) == 3
    finally:
        eng.shutdown()
    assert _wait(lambda: any("serving.decode" in f
                             for f in os.listdir(tmp_path)))
    path = next(os.path.join(tmp_path, f) for f in os.listdir(tmp_path)
                if "serving.decode" in f)
    with open(path) as fh:
        bundle = json.load(fh)
    assert bundle["reason"] == "step_timeout:serving.decode"
    assert bundle["schema"] == "paddle_tpu.crash_dump.v1"
    assert any(e["kind"] == "fault" and e["name"] == "serving.decode"
               for e in bundle["flight_events"])
    assert bundle["threads"] and "hbm_ledger" in bundle


def test_model_routing_to_lora_adapter(models):
    """``model=`` names an adapter: the adapter's greedy tokens must
    differ from the base model's (checked here, so the routing check
    means something) and equal the merged model's bit for bit."""
    _, pm = models
    cfg = pm.config
    ad = make_lora(cfg, rank=4, seed=20, name="tenant-a", std=0.5)
    reg = AdapterRegistry(pm, max_resident=2, max_rank=8)
    reg.register(ad)
    merged = build_gpt("gpt-tiny", device="cpu", max_position_embeddings=128)
    merged.load_state_dict(pm.state_dict())
    merge_into_qkv(merged, ad)
    prompt = [2, 3, 4, 5, 6, 7, 8, 9]
    eng = _engine(merged, max_slots=1)
    want = [int(t) for t in eng.submit(prompt, max_new_tokens=6).result(
        timeout=TIMEOUT)]
    eng.shutdown()
    with gw.start_gateway([_engine(pm, max_slots=2, adapters=reg)],
                          own_engines=True) as stack:
        outs = {}
        for model in (None, "tenant-a"):
            body = {"prompt": prompt, "max_tokens": 6}
            if model:
                body["model"] = model
            status, _, raw = _post(stack.port, body)
            assert status == 200, raw
            outs[model] = json.loads(raw)["choices"][0]["token_ids"]
        assert outs["tenant-a"] != outs[None], \
            "the adapter must change the greedy tokens for this check"
        assert outs["tenant-a"] == want
        status, _, raw = _post(stack.port, {"prompt": prompt,
                                            "model": "tenant-z"})
        assert status == 404
        assert json.loads(raw)["error"]["code"] == "model_not_found"


def test_gateway_clean_shutdown_fails_queued(models):
    _, pm = models
    eng = _engine(pm, max_slots=1, auto_start=False)
    g = gw.Gateway([eng], start=False)
    creq = gw.parse_completion_request(
        json.dumps({"prompt": [1, 2], "max_tokens": 2}).encode(),
        has_tokenizer=False)
    item = g.admit(creq, "t")
    g.shutdown()
    assert isinstance(item.error, gw.GatewayClosedError)
    with pytest.raises(gw.GatewayClosedError):
        g.admit(creq, "t")
    g.shutdown()                               # idempotent
    eng.shutdown()


def test_dispatcher_fault_degrades_healthz(models):
    _, pm = models
    eng = _engine(pm, max_slots=1)
    # the module's `stacks` gateway crosses the same seam every poll: the
    # one shot matches only the dispatcher of the gateway under test
    g = gw.Gateway([eng], start=False)
    faults.arm("gateway.dispatch", exc=RuntimeError("dispatcher died"),
               times=1, match={"gateway": g})
    g.start()
    with gw.start_gateway(g, own_engines=True) as stack:
        assert _wait(lambda: not stack.gateway.dispatcher_alive())
        status, raw = _get(stack.port, "/healthz")
        health = json.loads(raw)
        assert status == 503 and not health["dispatcher_alive"]
        assert "dispatcher died" in health["dispatcher_error"]
        status, _, raw = _post(stack.port, {"prompt": [1], "max_tokens": 1})
        assert status == 503


def test_slo_objectives_and_drain(models):
    _, pm = models
    from paddle_tpu_torch.observability.slo import SloObjective

    eng = _engine(pm, max_slots=1)
    objective = SloObjective("avail", "availability", 0.9)
    with gw.start_gateway([eng], slo_objectives=[objective],
                          slo_tick_s=0.05) as stack:
        assert stack.gateway.slo_engine is stack.slo_engine
        status, raw = _get(stack.port, "/debug/slo")
        assert status == 200
        assert json.loads(raw)["objectives"][0]["name"] == "avail"
    assert not stack.slo_engine._thread.is_alive()
    with gw.start_gateway([eng]) as stack:
        assert stack.gateway.drain(deadline_s=30.0)
        status, headers, raw = _post(stack.port, {"prompt": [1]})
        assert status == 429 and int(headers["Retry-After"]) >= 1
        assert json.loads(raw)["error"]["code"] == "draining"
    eng.shutdown()


def test_concurrent_streams_match_sequential_tokens(models):
    """12 streamed clients at once against two slots: every stream
    completes with the tokens the same prompt gets alone, and the
    completed counter moves by exactly 12."""
    import threading

    _, pm = models
    prompts = [[3 + i, 9, 4 + 2 * i] for i in range(12)]
    with gw.start_gateway([_engine(pm, max_slots=2, max_queue=4)],
                          own_engines=True,
                          tenants=[gw.TenantConfig("t", max_queue=16)]) \
            as stack:
        alone = [json.loads(_post(stack.port, {"prompt": p,
                                               "max_tokens": 5},
                                  headers={"X-Tenant": "t"})[2])
                 ["choices"][0]["token_ids"] for p in prompts]
        m = obs.registry().get("paddle_tpu_gateway_requests_total")
        done0 = m.value({"tenant": "t", "outcome": "completed"})
        out = [None] * len(prompts)

        def one(i):
            status, _, raw = _post(stack.port, {"prompt": prompts[i],
                                                "max_tokens": 5,
                                                "stream": True},
                                   headers={"X-Tenant": "t"})
            ev = _sse(raw)
            out[i] = (status, [t for e in ev[:-1]
                               for t in e["choices"][0]["token_ids"]])

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(TIMEOUT)
        assert not any(th.is_alive() for th in threads)
        assert [o[0] for o in out] == [200] * len(prompts)
        assert [o[1] for o in out] == alone
        assert _wait(lambda: m.value({"tenant": "t", "outcome":
                                      "completed"}) == done0 + 12)


class _CharTokenizer:
    """A toy tokenizer: one id per character."""

    def encode(self, text):
        return [ord(c) % 1000 for c in text]

    def decode(self, ids):
        return "".join(chr(97 + i % 26) for i in ids)


def test_string_prompts_through_a_tokenizer(models):
    _, pm = models
    tok = _CharTokenizer()
    eng = _engine(pm, max_slots=1, tokenizer=tok)
    want = eng.submit("hello", max_new_tokens=4).result(timeout=TIMEOUT)
    with gw.start_gateway([EngineSupervisor(lambda: eng)],
                          own_engines=True) as stack:
        status, _, raw = _post(stack.port, {"prompt": "hello",
                                            "max_tokens": 4})
        assert status == 200, raw
        choice = json.loads(raw)["choices"][0]
        assert choice["token_ids"] == [int(t) for t in want]
        assert choice["text"] == tok.decode(choice["token_ids"])
        status, _, raw = _post(stack.port, {"prompt": "hello",
                                            "max_tokens": 4, "stop": "ab"})
        assert status == 400
        assert json.loads(raw)["error"]["code"] == "invalid_stop"
        stop = choice["token_ids"][1]
        status, _, raw = _post(stack.port, {"prompt": "hello",
                                            "max_tokens": 4,
                                            "stop": chr(stop)})
        body = json.loads(raw)["choices"][0]
        assert status == 200 and body["finish_reason"] == "stop"
        assert body["token_ids"][-1] == stop
