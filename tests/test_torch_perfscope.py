"""The port's device perfscope against the JAX package's, and on the card.

On the CPU: the same registered costs and sampled seconds give the same
roofline rows and MFU against the synthetic peak (1 TFLOP/s, 100 GB/s,
the JAX package's cpu row); the sampling cadence (with sampling off the
engine never reaches the barrier; every Nth decode step otherwise, at
ONE decode signature); the decode signature's cost from the shapes; the
device memory ledger (the same operations give the JAX ledger's
snapshot; the engine's rows match its ``stats()`` bytes and go with its
shutdown); OOM forensics on torch's ``OutOfMemoryError``; and
``/debug/perf`` / ``/debug/memory`` through the gateway.  The tests marked
``cuda`` hold the CUDA-event timer to the engine's own replay events and
the ledger to ``torch.cuda.memory_allocated`` on the card; they skip here
(decided in a fixture, so every worker collects the same tests).
"""
import http.client
import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from paddle_tpu.observability import perfscope as jax_perfscope

from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.models import build_gpt
from paddle_tpu_torch.observability import flight, perfscope
from paddle_tpu_torch.serving import Engine
from paddle_tpu_torch.serving import gateway as gw

torch.set_num_threads(1)

TIMEOUT = 120


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    """Telemetry on, sampling off, fresh program stats, the synthetic
    peak pinned and crash dumps into tmp, around every test."""
    monkeypatch.setenv("PADDLE_TPU_DUMP_DIR", str(tmp_path / "dumps"))
    obs.enable(True)
    perfscope.set_sample_every(0)
    perfscope.reset_programs()
    perfscope.reset_oom_dumps()
    perfscope.set_peaks(1e12, 100e9)
    yield
    perfscope.set_sample_every(0)
    perfscope.reset_programs()
    perfscope.reset_oom_dumps()
    perfscope.reset_peaks()
    obs.disable()
    obs.registry().reset()


@pytest.fixture
def cuda():
    """Decides at run time, never at collection: every worker collects
    the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the chip)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _program_run(mod, every):
    mod.set_sample_every(every)
    mod.register_cost("p.decode", "sig-a", {"flops": 4e9,
                                            "bytes accessed": 2e8})
    mod.register_cost("p.decode", "sig-b", {"flops": 1e9,
                                            "bytes accessed": 1e9})
    mod.register_cost("p.prefill", "sig-c", {"flops": 8e9})
    out = []
    for i in range(7):
        if mod.poll_sample("p.decode"):
            out.append(i)
            mod.record_sample("p.decode", "sig-a", 0.002 + 0.001 * i)
    mod.record_sample("p.prefill", "sig-c", 0.016)
    report = mod.perf_report()
    for row in report["programs"]:
        row.pop("dtype", None)
        row.pop("peak_flops", None)
    stats = mod.program_stats("p.decode")
    for cost in stats["costs"].values():
        cost.pop("dtype", None)               # the port's peak selector
    return out, report, stats, \
        [(e["name"], e["dur"], e["args"]) for e in mod.chrome_events()]


@pytest.mark.parametrize("every", [0, 1, 3])
def test_roofline_rows_match_jax(every):
    jax_perfscope.reset_programs()
    jax_perfscope.set_peaks(1e12, 100e9)
    try:
        want = _program_run(jax_perfscope, every)
        got = _program_run(perfscope, every)
    finally:
        jax_perfscope.set_sample_every(0)
        jax_perfscope.reset_programs()
        jax_perfscope.reset_peaks()
    assert got == want
    report = got[1]
    if every:
        row = next(r for r in report["programs"] if r["program"] ==
                   "p.decode")
        mean = row["device_s"] / row["sampled"]
        assert row["mfu"] == pytest.approx(round(4e9 / (mean * 1e12), 6))
        assert row["hbm_bw_frac"] == pytest.approx(
            round(2e8 / (mean * 100e9), 6))
        g = obs.registry().get(perfscope.DEVICE_PROGRAM_MFU)
        assert g.value({"program": "p.decode"}) == pytest.approx(
            4e9 / ((0.002 + 0.001 * got[0][-1]) * 1e12))


def test_peak_table_and_synthetic_cpu_entry():
    flops, bw = perfscope.peaks_for("NVIDIA H100 80GB HBM3")
    assert flops == {"bfloat16": 989e12, "float16": 989e12,
                     "float32": 67e12} and bw == 3.35e12
    assert perfscope.peaks_for("NVIDIA A100-SXM4-80GB") == ({}, 0.0)
    assert perfscope.peaks_for("NVIDIA H100 PCIe") == ({}, 0.0)
    perfscope.reset_peaks()
    jax_perfscope.reset_peaks()
    if not torch.cuda.is_available():
        # without a card: the synthetic entry, the JAX package's cpu row
        assert perfscope.peaks("float32") == jax_perfscope.peaks() == \
            (1e12, 100e9)
    perfscope.register_cost("unknown.card", "k", {"flops": 1e9,
                                                  "dtype": "float32"})
    perfscope._peaks[0] = ({}, 0.0)              # a card the table lacks
    perfscope.record_sample("unknown.card", "k", 0.01)
    assert perfscope.program_stats("unknown.card")["last"]["mfu"] is None


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    return build_gpt("gpt-tiny", device="cpu", max_position_embeddings=128)


def _serve(eng, n=3, new=5):
    try:
        outs = [h.result(timeout=TIMEOUT) for h in
                [eng.submit(np.arange(2 + i, 9 + i), max_new_tokens=new)
                 for i in range(n)]]
        return outs, eng.stats()
    finally:
        eng.shutdown()


@pytest.mark.parametrize("every", [0, 1, 2])
def test_engine_sampling_cadence(tiny, monkeypatch, every):
    calls = []
    barrier = perfscope.block_ready
    monkeypatch.setattr(perfscope, "block_ready",
                        lambda x: (calls.append(x), barrier(x)))
    perfscope.set_sample_every(every)
    outs, st = _serve(Engine(tiny, device="cpu", max_slots=2, max_len=64,
                             page_size=8))
    steps = st["decode_steps"]
    stats = perfscope.program_stats("serving.decode")
    assert st["decode_compiles"] == 1, "sampling must not add a signature"
    assert stats["signatures"] == 1
    if every == 0:
        assert calls == [] and stats["sampled"] == 0
        assert stats["dispatches"] == 0      # not even counted when off
    else:
        assert stats["dispatches"] == steps
        assert stats["sampled"] == len(calls) == steps // every
        assert stats["last"]["mfu"] > 0 and stats["last"]["bw_frac"] > 0


def test_decode_signature_cost_from_shapes(tiny):
    eng = Engine(tiny, device="cpu", max_slots=2, max_len=64, page_size=8)
    _serve(eng, n=1, new=3)
    cfg = tiny.config
    h, L, V = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    H = cfg.num_attention_heads
    rows = 3                                      # 2 slots + the scratch
    n_pt, P = 8, 8
    # the signature's cost: both live lanes at their longest start
    f_att, b_att = pa.paged_cost([n_pt * P - 1] * 2 + [n_pt * P], 1, H,
                                 h // H, P, n_pt, False)
    cost = perfscope.program_stats("serving.decode")["costs"]
    (only,) = cost.values()
    assert only["dtype"] == "float32"
    assert only["flops"] == 2.0 * rows * (L * 12 * h * h + V * h) + \
        L * f_att
    weights = sum(t.numel() * 4 for t in tiny.state_dict().values())
    assert only["bytes"] == weights + L * b_att + 4.0 * rows * V


def _ledger_run(mod):
    led = mod.HbmLedger()
    w = led.register("weights", 1000, detail="w")
    k = led.register("kv_pool", 4096)
    p = led.register("prefix_cache", 0, nested=True)
    p.update(512)
    k.add(-96)
    k.add(-10 ** 9)                              # clamped at 0
    k.update(4000)
    w.release()
    w.release()                                  # idempotent
    w.update(5)                                  # released: ignored
    led.register("host_prefix", 300)
    snap = led.snapshot()
    return snap, led.owner_bytes(), led.nested_bytes(), led.total()


def test_ledger_matches_jax():
    assert _ledger_run(perfscope) == _ledger_run(jax_perfscope)


def test_engine_ledger_rows_follow_the_build(tiny):
    led = perfscope.ledger()
    before = led.rows()
    eng = Engine(tiny, device="cpu", max_slots=2, max_len=64, page_size=8,
                 prefix_cache=True, prefix_block=8)
    st = eng.stats()
    mine = [r for r in led.rows() if r not in before]
    by_owner = {r["owner"]: r for r in mine}
    assert by_owner["weights"]["bytes"] == st["weight_bytes"]
    assert by_owner["kv_pool"]["bytes"] == st["kv_pool_bytes"]
    assert by_owner["prefix_cache"]["nested"]
    g = obs.registry().get(perfscope.HBM_BYTES)
    assert g.value({"owner": "kv_pool"}) >= st["kv_pool_bytes"]
    try:
        eng.submit(np.arange(1, 20), max_new_tokens=4).result(
            timeout=TIMEOUT)
        assert eng.join(timeout=TIMEOUT)
        cached = eng.stats()["kv_pages_cached"]
        assert cached > 0
        row = next(r for r in led.rows() if r not in before
                   and r["owner"] == "prefix_cache")
        assert row["bytes"] == cached * (st["kv_pool_bytes"] //
                                         (st["kv_num_pages"] + 1))
        rep = perfscope.memory_report()
        assert rep["total_tracked"] >= st["weight_bytes"] + \
            st["kv_pool_bytes"]
        assert rep["backend"] == {} and "unattributed" not in rep
    finally:
        eng.shutdown()
    assert [r for r in led.rows() if r not in before] == []


def test_oom_forensics(tmp_path):
    flight.clear()
    assert not perfscope.note_exception(ValueError("shape mismatch"), "p")
    err = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "2.00 GiB")
    assert perfscope.looks_like_oom(err)
    assert perfscope.looks_like_oom(RuntimeError("RESOURCE_EXHAUSTED: hbm"))
    row = perfscope.ledger().register("kv_pool", 123)
    try:
        assert perfscope.note_exception(err, "serving")
        assert perfscope.note_exception(err, "serving")   # one bundle
    finally:
        row.release()
    ev = flight.events("oom")
    assert len(ev) == 2 and ev[0]["name"] == "serving"
    dumps = os.listdir(tmp_path / "dumps")
    assert len(dumps) == 1 and "resource_exhausted_serving" in dumps[0]
    with open(tmp_path / "dumps" / dumps[0]) as fh:
        bundle = json.load(fh)
    assert any(r["owner"] == "kv_pool" and r["bytes"] == 123
               for r in bundle["hbm_ledger"]["rows"])


def test_debug_perf_and_memory_endpoints(tiny):
    perfscope.set_sample_every(1)
    eng = Engine(tiny, device="cpu", max_slots=2, max_len=64, page_size=8)
    with gw.start_gateway([eng], own_engines=True) as stack:
        def get(path):
            conn = http.client.HTTPConnection("127.0.0.1", stack.port,
                                              timeout=TIMEOUT)
            try:
                if path.startswith("/v1"):
                    conn.request("POST", path, json.dumps(
                        {"prompt": [1, 2, 3], "max_tokens": 4}).encode(),
                        {"Content-Type": "application/json"})
                else:
                    conn.request("GET", path)
                r = conn.getresponse()
                return r.status, json.loads(r.read())
            finally:
                conn.close()

        assert get("/v1/completions")[0] == 200
        status, perf = get("/debug/perf")
        assert status == 200 and perf["sample_every"] == 1
        row = next(r for r in perf["programs"]
                   if r["program"] == "serving.decode")
        assert row["sampled"] == row["dispatches"] == 3
        assert row["mfu"] > 0 and row["share"] == 1.0
        assert row["peak_flops"] == 1e12
        status, mem = get("/debug/memory")
        assert status == 200
        assert mem["owners"]["kv_pool"] >= eng.stats()["kv_pool_bytes"]
        assert {"owners", "nested", "total_tracked", "backend",
                "rows"} <= set(mem)
    lane = perfscope.chrome_events()
    assert lane and all(e["cat"] == "device" and
                        e["tid"] == "device:serving.decode" for e in lane)


# -- on the card ---------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_event_timer_books_the_replays(cuda):
    perfscope.reset_peaks()
    perfscope.set_sample_every(1)
    model = build_gpt("gpt-tiny", device=cuda, max_position_embeddings=128)
    outs, st = _serve(Engine(model, max_slots=2, max_len=64, page_size=8,
                             device=cuda))
    stats = perfscope.program_stats("serving.decode")
    assert st["decode_compiles"] == 1
    assert stats["sampled"] == st["decode_graph_replays"] == \
        st["decode_steps"]
    # the sampled device seconds are the replays' own CUDA events
    assert stats["device_seconds"] == pytest.approx(
        st["decode_device_seconds"], rel=1e-9)
    assert stats["last"]["seconds"] > 0
    name = torch.cuda.get_device_name(0)
    if "H100 80GB HBM3" in name:
        assert perfscope.peaks("float32") == (67e12, 3.35e12)
        assert 0 < stats["last"]["mfu"] < 1
        assert 0 < stats["last"]["bw_frac"] < 1


@pytest.mark.cuda
def test_ledger_reconciles_with_memory_allocated(cuda):
    model = build_gpt("gpt-tiny", device=cuda, max_position_embeddings=128)
    eng = Engine(model, max_slots=2, max_len=64, page_size=8, device=cuda)
    try:
        eng.submit(np.arange(1, 9), max_new_tokens=4).result(
            timeout=TIMEOUT)
        st = eng.stats()
        torch.cuda.synchronize()
        rep = perfscope.memory_report()
        assert rep["backend"]["bytes_in_use"] == \
            torch.cuda.memory_allocated(0)
        assert rep["owners"]["kv_pool"] >= st["kv_pool_bytes"]
        mine = st["weight_bytes"] + st["kv_pool_bytes"]
        assert mine <= rep["backend"]["bytes_in_use"]
        assert rep["unattributed"] == rep["backend"]["bytes_in_use"] - \
            rep["total_tracked"]
        perfscope.record_memory_stats()
        g = obs.registry().get(perfscope.MEMORY_GAUGE)
        assert g.value({"stat": "bytes_limit"}) > 0
    finally:
        eng.shutdown()
