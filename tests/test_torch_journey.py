"""The port's request journeys and ``TelemetryWindow`` against the JAX
package's, and the journeys the port's engine writes.

The same phase records, laid on the same clock, give the same timeline
dicts in both packages: explicit ``unattributed`` gaps, overlaps clipped
against the forward cursor, shadowed records kept as zero segments, the
phase cap's merging.  The same samples give the same window snapshots
(percentiles, shares, per-key grouping, expiry, key eviction).  Then the
engine: ``Engine.submit(journey=)`` on gpt-tiny gives the same sequence of
attributed phases as the JAX engine's for the same request, the phases
partition the wall time exactly, decode phases carry the drafted and
accepted counts, and a page stall is attributed.  Every wait is bounded.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import paddle_tpu as paddle
from paddle_tpu.models import build_gpt as jax_build_gpt
from paddle_tpu.models import gpt_config as jax_gpt_config
from paddle_tpu.observability import journey as jax_journey
from paddle_tpu.serving import Engine as JaxEngine

from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.models import build_gpt, load_jax_state
from paddle_tpu_torch.observability import flight, journey
from paddle_tpu_torch.serving import Engine

torch.set_num_threads(1)

TIMEOUT = 120
BASE = 1000.0       # the journeys' t0 on the shared fake clock


def _timeline(mod, records, t_end, outcome="ok", first=None, jid="j-1"):
    """One journey of ``mod`` at t0 = BASE with ``records`` (name, start
    offset, duration, attrs) finished at BASE + t_end; the per-package
    ids and wall-clock stamps masked."""
    j = mod.begin(jid, tenant="t")
    try:
        j.t0 = BASE
        for name, off, dur, attrs in records:
            j.phase(name, BASE + off, dur, **attrs)
        if first is not None:
            j.mark_first_token(BASE + first)
        j.finish(outcome, t_end=BASE + t_end)
        tl = j.timeline()
    finally:
        mod.clear()
    tl.pop("t_start_unix")
    return tl, j.phase_totals(), j.ttft_s, j.wall_s


TIMELINES = {
    "gaps": ([("parse", 0.0, 0.001, {"body_bytes": 40}),
              ("queue", 0.003, 0.002, {"tenant": "t"}),
              ("prefill", 0.006, 0.01, {"n": 2}),
              ("decode", 0.02, 0.004, {"emitted": 1})], 0.03),
    "overlap_clipped": ([("admit", 0.0, 0.005, {}),
                         ("engine_queue", 0.002, 0.006, {"slot": 1}),
                         ("prefill", 0.007, 0.003, {})], 0.012),
    "shadowed_kept": ([("decode", 0.0, 0.01, {}),
                       ("route", 0.002, 0.001, {"engine": "e0"}),
                       ("stream", 0.003, 0.0, {})], 0.01),
    "out_of_order": ([("decode", 0.02, 0.01, {"emitted": 2}),
                      ("prefill", 0.0, 0.015, {}),
                      ("queue", 0.016, 0.001, {})], 0.05),
    "tail_jitter": ([("respond", 0.0, 0.0099999, {})], 0.01),
    "past_the_end": ([("decode", 0.005, 1.0, {})], 0.02),
    "empty": ([], 0.004),
}


@pytest.mark.parametrize("name", sorted(TIMELINES))
@pytest.mark.parametrize("first", [None, 0.006])
def test_timeline_matches_jax(name, first):
    records, t_end = TIMELINES[name]
    got = _timeline(journey, records, t_end, first=first)
    want = _timeline(jax_journey, records, t_end, first=first)
    assert got == want
    tl = got[0]
    assert abs(sum(p["dur_ms"] for p in tl["phases"]) - tl["wall_ms"]) < 0.01
    assert all(p["dur_ms"] >= 0 for p in tl["phases"])


def test_phase_cap_merges_like_jax():
    records = [("decode", 0.001 * i, 0.0005, {"emitted": 1, "drafted": 3,
                                              "accepted": i % 2})
               for i in range(journey._PHASE_CAP + 20)]
    got = _timeline(journey, records, 1.0)
    want = _timeline(jax_journey, records, 1.0)
    assert got == want
    assert got[0]["merged_phase_records"] == 20


def test_registry_ids_and_slow_hook():
    journey.clear()
    try:
        a = journey.begin("dup")
        b = journey.adopt_or_begin("dup")
        assert a.id == "dup" and b.id.startswith("dup-")
        assert journey.adopt_or_begin(" \x00weird id\n").id == "weird id"
        minted = journey.adopt_or_begin(None)
        assert minted.id.startswith("req-") and len(minted.id) == 20
        assert {j.id for j in journey.active()} == {a.id, b.id, minted.id,
                                                    "weird id"}
        flight.clear()
        journey.set_slow_ms(1.0)
        a.phase("decode", a.t0, 0.5)
        a.finish("ok", t_end=a.t0 + 0.5)
        a.finish("late")                    # idempotent: first call wins
        assert a.outcome == "ok" and journey.get("dup") is a
        assert journey.recent(1) == [a] and a not in journey.active()
        slow = flight.events("journey")
        assert slow and slow[-1]["attrs"]["request"] == "dup"
        a.phase("decode", a.t0, 1.0)        # a late echo is dropped
        assert len(a.phases()) == 1
        events = journey.chrome_events([a])
        assert events[0]["cat"] == "journey" and events[0]["tid"] == "dup"
        hist = obs.registry().get(journey.JOURNEY_PHASE_SECONDS)
        assert hist.count({"phase": "decode", "outcome": "ok"}) >= 1
    finally:
        journey.set_slow_ms(None)
        journey.clear()


# -- the window ----------------------------------------------------------------

def _feed(mod, win):
    rs = np.random.RandomState(3)
    t = 0.0
    for i in range(60):
        t += float(rs.exponential(0.5))
        win.observe_sample(
            now=t, wall_s=float(rs.uniform(0.1, 2)),
            ttft_s=None if i % 7 == 0 else float(rs.uniform(0.01, 0.5)),
            queue_wait_s=float(rs.uniform(0, 0.1)),
            token_s=float(rs.uniform(0.001, 0.02)),
            phase_totals={"decode": float(rs.uniform(0, 1)),
                          "queue": float(rs.uniform(0, 0.2)),
                          "unattributed": 0.001},
            outcome="ok" if i % 5 else "deadline_exceeded",
            redispatches=int(i % 11 == 0), rebuilds=int(i % 13 == 0),
            tenant=f"t{i % 3}", priority=("interactive", "batch")[i % 2])
        if i % 4 == 0:
            win.observe_shed("slo_shed" if i % 8 else "tenant_queue_full",
                             now=t, tenant=f"t{i % 3}", priority="batch")
    return t


@pytest.mark.parametrize("kw", [{}, {"window_s": 10.0},
                                {"window_s": 1000.0, "max_samples": 16,
                                 "max_keys": 2}],
                         ids=["default", "expiring", "bounded"])
def test_window_matches_jax(kw):
    def run(mod):
        win = mod.TelemetryWindow(**kw)
        t = _feed(mod, win)
        return [win.snapshot(now=t), win.snapshot(now=t, by="tenant"),
                win.snapshot(now=t, by="class"), win.keys(now=t),
                win.events(now=t, horizon_s=5.0, tenant="t1"),
                win.snapshot(now=t + 1e4)]
    assert run(journey) == run(jax_journey)
    with pytest.raises(ValueError):
        journey.TelemetryWindow(window_s=0)
    with pytest.raises(ValueError):
        journey.TelemetryWindow().snapshot(by="engine")


def test_window_observes_finished_journeys_like_jax():
    def run(mod):
        win = mod.TelemetryWindow()
        records = [("queue", 0.0, 0.01, {}), ("prefill", 0.01, 0.02, {}),
                   ("decode", 0.03, 0.01, {"emitted": 2}),
                   ("redispatch", 0.04, 0.001, {}),
                   ("decode", 0.05, 0.01, {"emitted": 1})]
        j = mod.begin("w-1", tenant="acme", priority="batch")
        j.t0 = BASE
        for name, off, dur, attrs in records:
            j.phase(name, BASE + off, dur, **attrs)
        j.mark_first_token(BASE + 0.03)
        win.observe_journey(j)                  # unfinished: skipped
        j.finish("ok", t_end=BASE + 0.07)
        win.observe_journey(j, now=BASE + 1)
        mod.clear()
        return win.snapshot(now=BASE + 1), win.snapshot(now=BASE + 1,
                                                        by="tenant")
    assert run(journey) == run(jax_journey)


# -- the engine's journeys -----------------------------------------------------

@pytest.fixture(scope="module")
def models():
    cfg = jax_gpt_config("gpt-tiny", max_position_embeddings=128,
                         hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    paddle.seed(5)
    jm = jax_build_gpt(cfg)
    jm.eval()
    pm = build_gpt("gpt-tiny", device="cpu", max_position_embeddings=128)
    load_jax_state(pm, {k: np.asarray(v._value)
                        for k, v in jm.state_dict().items()})
    return jm, pm


def _engine_phases(mod, engine, prompt, new, **kw):
    """Serve one request with a journey; its attributed phase names (no
    gaps, no cold-start build) and the finished journey."""
    try:
        engine.submit(prompt[:2], max_new_tokens=2).result(timeout=TIMEOUT)
        j = mod.begin(None)
        h = engine.submit(prompt, max_new_tokens=new, journey=j, **kw)
        out = h.result(timeout=TIMEOUT)
        j.finish("ok")
    finally:
        engine.shutdown()
    names = [p["phase"] for p in j.phases()
             if p["phase"] not in (mod.UNATTRIBUTED, "build")]
    return names, j, out


def test_engine_phases_match_jax_engine(models):
    jm, pm = models
    kw = dict(max_slots=2, max_len=64, paged_kv=True, page_size=8)
    prompt = np.arange(3, 14).astype(np.int64)
    want, _, want_out = _engine_phases(
        jax_journey, JaxEngine(jm, decode_kernel="pallas", **kw), prompt, 5)
    got, j, got_out = _engine_phases(journey, Engine(pm,
                                                     decode_kernel="pallas",
                                                     sample_on_device=False,
                                                     **kw),
                                     prompt, 5)
    np.testing.assert_array_equal(got_out, want_out)
    assert got == want
    assert got == ["engine_queue", "prefill"] + ["decode"] * 4
    phases = j.phases()
    assert abs(sum(p["dur"] for p in phases) - j.wall_s) < 1e-9
    for a, b in zip(phases, phases[1:]):
        assert abs(a["t"] + a["dur"] - b["t"]) < 1e-9   # a partition
    assert sum(p["attrs"].get("emitted", 0) for p in phases
               if p["phase"] == "decode") == 4
    assert j.ttft_s is not None and 0 < j.ttft_s <= j.wall_s


def test_speculative_decode_phases_carry_counts(models):
    _, pm = models
    eng = Engine(pm, paged_kv=True, decode_kernel="pallas",
                 sample_on_device=False, max_slots=2, max_len=64, page_size=8,
                 speculative_k=3)
    prompt = np.array([4, 5, 6, 4, 5, 6, 4, 5, 6], np.int64)
    _, j, out = _engine_phases(journey, eng, prompt, 8)
    decode = [p for p in j.phases() if p["phase"] == "decode"]
    assert decode and all(p["attrs"]["drafted"] == 2 for p in decode)
    assert sum(p["attrs"]["emitted"] for p in decode) == len(out) - 1
    # a run emits the model's token and the accepted drafts, cut at the
    # request's budget
    assert all(1 <= p["attrs"]["emitted"] <= p["attrs"]["accepted"] + 1
               for p in decode)
    assert any(p["attrs"]["accepted"] > 0 for p in decode)


def test_page_stall_is_attributed(models):
    """The head-of-line request waits for pages a running request holds:
    its engine-queue window splits at the stall into ``page_stall``."""
    _, pm = models
    eng = Engine(pm, paged_kv=True, decode_kernel="pallas",
                 sample_on_device=False, max_slots=2, max_len=64, page_size=8,
                 num_pages=4, auto_start=False)
    try:
        first = eng.submit(np.arange(1, 20), max_new_tokens=10)
        j = journey.begin(None)
        second = eng.submit(np.arange(2, 21), max_new_tokens=10, journey=j)
        eng.start()
        first.result(timeout=TIMEOUT)
        second.result(timeout=TIMEOUT)
        j.finish("ok")
        assert eng.stats()["page_alloc_stalls"] >= 1
    finally:
        eng.shutdown()
        journey.clear()
    names = [p["phase"] for p in j.phases()]
    assert names.index("engine_queue") < names.index("page_stall") < \
        names.index("prefill")
    stall = next(p for p in j.phases() if p["phase"] == "page_stall")
    assert stall["dur"] > 0
    assert any(e["name"] == "page_alloc_stall"
               for e in flight.events("serving"))
