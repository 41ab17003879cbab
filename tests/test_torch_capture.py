"""The port's traffic capture against the JAX package's.

The same arrivals recorded at the same offsets give the same entries in
both packages (lengths, the prompt hash, the sampling triple, the shape
mode's hashed conversation, the full mode's ids), the same ring bound and
drop count, the same spill files after the same rotations, the same
``tail`` section and filters, and ``fit_params`` / ``fit_trace`` give the
same fit of one capture.  Then the port's gateway records every admission,
admitted or shed, with its journey id, served at ``/debug/capture``.
"""
import http.client
import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from paddle_tpu.observability import capture as jax_capture

from paddle_tpu_torch.models import build_gpt
from paddle_tpu_torch.observability import capture, watchdog
from paddle_tpu_torch.serving import Engine
from paddle_tpu_torch.serving import gateway as gw

torch.set_num_threads(1)


def _arrivals(n=40, seed=0):
    rs = np.random.RandomState(seed)
    t = 0.0
    out = []
    for i in range(n):
        t += float(rs.exponential(0.2 if 15 <= i < 25 else 1.0))
        plen = int(rs.randint(4, 200))
        out.append(dict(
            t=round(t, 4), tenant=("a", "b", "c")[i % 3],
            priority=("standard", "batch")[i % 2],
            outcome="admitted" if i % 6 else "slo_shed",
            prompt=list(rs.randint(0, 1000, plen)) if i % 5 else None,
            text=None if i % 5 else f"text prompt {i}",
            max_tokens=int(rs.randint(1, 64)),
            deadline_s=None if i % 4 else 2.0,
            temperature=0.0 if i % 3 else 0.7, top_k=i % 4, seed=i,
            model=None if i % 2 else "tenant-a", journey_id=f"req-{i}",
            conversation=None if i % 7 else f"conv-{i % 2}"))
    return out


def _record_all(cap, arrivals):
    return [cap.record(**a) for a in arrivals]


@pytest.mark.parametrize("mode", ["shape", "full"])
@pytest.mark.parametrize("max_entries", [8, 100])
def test_ring_entries_match_jax(mode, max_entries):
    mine = capture.TrafficCapture(max_entries=max_entries, mode=mode)
    theirs = jax_capture.TrafficCapture(max_entries=max_entries, mode=mode)
    arr = _arrivals()
    assert _record_all(mine, arr) == _record_all(theirs, arr)
    assert mine.entries() == theirs.entries()
    assert len(mine.entries()) == min(max_entries, len(arr))
    assert mine.stats() == theirs.stats()
    for kw in ({"last": 3}, {"tenant": "b"}, {"outcome": "slo_shed"},
               {"conversation": "conv-0"}):
        assert mine.entries(**kw) == theirs.entries(**kw)
    assert mine.tail(5) == theirs.tail(5)
    assert mine.debug_state(last=4) == theirs.debug_state(last=4)
    if mode == "shape":
        assert all("prompt" not in e for e in mine.entries())
        assert all(e["conversation"] in (None,) or
                   not e["conversation"].startswith("conv")
                   for e in mine.entries())
    mine.clear()
    assert mine.stats()["recorded"] == 0 and mine.entries() == []
    with pytest.raises(ValueError, match="capture mode"):
        capture.TrafficCapture(mode="everything")


def test_spill_round_trip_and_rotation_match_jax(tmp_path):
    arr = _arrivals(60, seed=1)
    out = []
    for mod, sub in ((capture, "port"), (jax_capture, "jax")):
        d = str(tmp_path / sub)
        cap = mod.TrafficCapture(max_entries=16, mode="full", spill_dir=d,
                                 spill_max_bytes=4096, spill_files=2)
        try:
            entries = _record_all(cap, arr)
            assert cap.flush(timeout=60)
        finally:
            cap.close()
        files = sorted(os.listdir(d))
        lines = []
        for f in sorted(files, reverse=True):        # oldest file first
            with open(os.path.join(d, f)) as fh:
                lines += [json.loads(ln) for ln in fh]
        out.append((files, cap.stats()["spill"]["rotations"],
                    cap.stats()["spill"]["spilled"], lines, entries))
    (pf, prot, pspill, plines, pent), (jf, jrot, jspill, jlines, _) = out
    assert (pf, prot, pspill) == (jf, jrot, jspill)
    assert prot >= 1 and pspill == len(arr)
    assert plines == jlines
    # what survived the rotation is the newest tail of what was recorded
    assert plines == pent[-len(plines):]


@pytest.mark.parametrize("seed", [0, 3])
def test_fit_matches_jax(seed):
    arr = _arrivals(80, seed=seed)
    cap = capture.TrafficCapture(max_entries=200)
    entries = _record_all(cap, arr)
    want = jax_capture.fit_params(entries)
    got = capture.fit_params(entries)
    assert got == want
    assert capture.fit_params(entries, bin_s=2.0) == \
        jax_capture.fit_params(entries, bin_s=2.0)
    assert capture.fit_trace(entries, seed=seed) == \
        jax_capture.fit_trace(entries, seed=seed)
    with pytest.raises(ValueError, match=">= 2"):
        capture.fit_params(entries[:1])


def test_process_default_and_crash_section():
    prev = capture.get_capture()
    try:
        cap = capture.set_capture(capture.TrafficCapture(max_entries=4))
        assert capture.get_capture() is cap
        cap.record(tenant="x", priority="standard", outcome="admitted",
                   prompt=[1, 2, 3], journey_id="req-x")
        bundle = watchdog.collect("capture")
        assert bundle["capture_tail"]["entries"][0]["journey_id"] == "req-x"
        assert "prompt" not in bundle["capture_tail"]["entries"][0]
    finally:
        capture.set_capture(prev)


def test_gateway_records_every_admission(tmp_path):
    pm = build_gpt("gpt-tiny", device="cpu", max_position_embeddings=128)
    eng = Engine(pm, device="cpu", max_slots=2, max_len=64, page_size=8)
    shedder = gw.LoadShedder()
    shedder.seed(prefill_s=10.0, token_s=1.0)    # every deadline blows
    with gw.start_gateway([eng], own_engines=True, capture_mode="full",
                          capture_entries=16, shedder=shedder) as stack:
        def post(body, rid):
            conn = http.client.HTTPConnection("127.0.0.1", stack.port,
                                              timeout=120)
            try:
                conn.request("POST", "/v1/completions",
                             json.dumps(body).encode(),
                             {"Content-Type": "application/json",
                              "X-Request-Id": rid, "X-Tenant": "acme"})
                r = conn.getresponse()
                r.read()
                return r.status
            finally:
                conn.close()

        assert post({"prompt": [1, 2, 3], "max_tokens": 2, "seed": 4},
                    "cap-ok") == 200
        assert post({"prompt": [4, 5], "max_tokens": 2,
                     "deadline_ms": 50}, "cap-shed") == 429
        conn = http.client.HTTPConnection("127.0.0.1", stack.port,
                                          timeout=120)
        conn.request("GET", "/debug/capture?last=8&tenant=acme")
        state = json.loads(conn.getresponse().read())
        conn.close()
    assert state["mode"] == "full" and state["max_entries"] == 16
    window = state["window"]
    assert [e["outcome"] for e in window] == ["admitted", "slo_shed"]
    assert [e["journey_id"] for e in window] == ["cap-ok", "cap-shed"]
    assert window[0]["prompt"] == [1, 2, 3] and window[0]["seed"] == 4
    assert window[1]["deadline_s"] == pytest.approx(0.05)
