"""Fleet control end to end on the CPU: ``bench.py``'s closed-loop blocks
and the repository's HTTP tools, against the port.

``chip_smoke.py`` ports ``bench.py``'s three closed-loop blocks
(``_bench_autoscale_curve``, ``_bench_slo_alerting``,
``_bench_capture_fit``) over the port's ``FleetSim``, ``SloEvaluator`` and
``capture.fit_trace``; given the same ``measured`` latencies, each returns
the JAX bench's dict.  Then the tools that read a live gateway over the
wire (``tools/incident_report.py``, ``tools/journey_report.py``,
``tools/replay_capture.py``) run against the port's gateway on gpt-tiny:
the incident listing and sheet, the journeys' chrome trace and summary,
and a shape-mode capture replayed with every request completed.
"""
import contextlib
import io
import json
import sys
import time

import pytest
import torch

pytest.importorskip("jax")

import bench
import chip_smoke
from tools import incident_report, journey_report, replay_capture

from paddle_tpu_torch.models import build_gpt
from paddle_tpu_torch.observability import journey, slo
from paddle_tpu_torch.serving import Engine
from paddle_tpu_torch.serving.gateway import TenantConfig, start_gateway
from paddle_tpu_torch.testing.load_gen import make_trace, replay_http

torch.set_num_threads(1)

# bench.py's serving leg builds `measured` from the engine's p50 TTFT and
# p50 token latency: a card-like pair and a slower, prefill-heavy one
MEASURED = [{"prefill_s": 0.0123, "token_s": 0.00171},
            {"prefill_s": 0.41, "token_s": 0.023}]
# the stack's engine queue and tenant FIFO: more than its trace's requests
HOLD = 64
BLOCKS = ["_bench_autoscale_curve", "_bench_slo_alerting",
          "_bench_capture_fit"]


@pytest.mark.parametrize("measured", MEASURED, ids=["card", "slow"])
@pytest.mark.parametrize("block", BLOCKS)
def test_bench_blocks_match_jax_bench(block, measured):
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        got = getattr(chip_smoke, block)(dict(measured))
        want = getattr(bench, block)(dict(measured))
    assert got == want
    assert all(got["gates"].values())


def test_capture_gate_fails_where_the_jax_bench_does():
    """At a prefill:token ratio near 11 the bench's fitted trace misses
    the source's marginal third scale-up: the port's block raises the
    JAX bench's own message there."""
    measured = {"prefill_s": 0.019, "token_s": 0.0017}
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        with pytest.raises(RuntimeError) as want:
            bench._bench_capture_fit(dict(measured))
        with pytest.raises(chip_smoke.BenchGateError) as got:
            chip_smoke._bench_capture_fit(dict(measured))
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith(chip_smoke.SEQUENCE_GATES)


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """A port gateway on gpt-tiny with the SLO engine on, capturing in
    shape mode; a burst of requests makes its objective fire.

    The engine's queue and tenant ``tools``'s FIFO each hold the whole
    trace: the replay below sends the capture at 4x, and on a loaded host
    decode is slow enough that more requests wait at once than a cap of
    16 (the tenant FIFO's default) admits, and admission would shed the
    rest with 429s."""
    torch.manual_seed(3)
    model = build_gpt("gpt-tiny", device="cpu", max_position_embeddings=128)
    objective = slo.SloObjective(
        "tools-ttft", "ttft_p99", 0.9, threshold_s=1e-4, fast_window_s=5.0,
        fast_burn=5.0, slow_window_s=30.0, slow_burn=2.0, fire_ticks=1,
        resolve_ticks=2, min_events=3)
    st = start_gateway(
        [Engine(model, paged_kv=True, decode_kernel="pallas",
                sample_on_device=False, max_slots=2, max_len=64,
                max_queue=HOLD)],
        tenants=[TenantConfig("tools", max_queue=HOLD)],
        own_engines=True, slo_objectives=[objective], slo_tick_s=0.1,
        slo_incident_dir=str(tmp_path_factory.mktemp("incidents")),
        capture_mode="shape")
    url = f"http://127.0.0.1:{st.port}"
    trace = make_trace(2.0, 4.0, seed=5, prompt_mean=6.0, out_mean=3.0,
                       prompt_max=16, out_max=6)
    assert len(trace) <= HOLD
    summary = replay_http(url, trace, vocab=256, seed=5, tenant="tools")
    assert summary["completed"] == len(trace) and summary["errors"] == 0
    assert summary["shed"] == 0
    deadline = time.time() + 60.0
    while not st.slo_engine.store.list():
        assert time.time() < deadline, "the objective never fired"
        time.sleep(0.05)
    yield st, url, len(trace)
    st.close()
    journey.clear()


def test_incident_report_renders_a_port_bundle(stack, monkeypatch, capsys):
    st, url, _ = stack
    ring = incident_report.fetch(url)["incidents"]
    assert ring and ring[0]["objective"] == "tools-ttft"
    inc_id = ring[-1]["id"]
    sheet = incident_report.render(incident_report.fetch(url, inc_id))
    assert inc_id in sheet and "tools-ttft" in sheet
    monkeypatch.setattr(sys, "argv", ["incident_report", "--url", url])
    assert incident_report.main() == 0
    assert inc_id in capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["incident_report", "--url", url,
                                      "--id", inc_id])
    assert incident_report.main() == 0
    assert "tools-ttft" in capsys.readouterr().out


def test_journey_report_reads_the_port_window(stack, tmp_path, capsys):
    st, url, n = stack
    timelines = journey_report.fetch_window(url, last=64)
    assert len(timelines) >= n
    summary = journey_report.summarize(timelines)
    assert {"prefill", "decode"} <= set(summary)
    assert abs(sum(r["share"] for r in summary.values()) - 1.0) < 1e-2
    out = tmp_path / "journeys.trace.json"
    assert journey_report.main(["--url", url, "--last", "64",
                                "-o", str(out)]) == 0
    events = json.loads(out.read_text())["traceEvents"]
    assert events and all(e["cat"] == "journey" for e in events)
    assert f"{len(timelines)} journeys" in capsys.readouterr().out


def test_replay_capture_replays_a_shape_mode_capture(stack, monkeypatch,
                                                      capsys):
    st, url, n = stack
    entries = replay_capture.fetch_capture(url, tenant="tools")
    assert len(entries) == n and all(e["tenant"] == "tools"
                                      for e in entries)
    assert not any(e.get("prompt") for e in entries)     # shape mode
    trace = replay_capture.to_trace(entries)
    assert trace[0]["t"] == 0.0 and len(trace) == n
    monkeypatch.setattr(sys, "argv", [
        "replay_capture", "--url", url, "--tenant", "tools", "--speed", "4",
        "--vocab", "256"])
    assert replay_capture.main() == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["requests"] == n and summary["completed"] == n
    assert summary["errors"] == 0 and summary["shed"] == 0


def test_fleet_memory_cycle_ends_after_the_drained_teardown(monkeypatch):
    """Smoke sub-phase 38b reads ``memory_allocated`` once a cycle's
    scale-down has torn its replica down: the router drops the replica
    before the teardown frees its pools, so a reading taken on the
    router's count alone sometimes holds a fourth build.  Here every
    build with live KV pools counts 64 MiB and every second teardown is
    slowed down; each cycle must read the two routed builds and the
    parked spare, and nothing more."""
    live, releases = [], [0]
    init, release = Engine.__init__, Engine._release_device

    def tracked_init(self, *a, **k):
        init(self, *a, **k)
        live.append(self)

    def slow_release(self):
        releases[0] += 1
        if releases[0] % 2 == 0:
            time.sleep(0.3)
        release(self)

    mib64 = 64 * 2 ** 20
    monkeypatch.setattr(Engine, "__init__", tracked_init)
    monkeypatch.setattr(Engine, "_release_device", slow_release)
    monkeypatch.setattr(chip_smoke, "_gpt2_small", lambda dev, seed, cpu:
                        (build_gpt("gpt-tiny", device="cpu",
                                   max_position_embeddings=1024), None))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a: mib64 * sum(
        1 for e in live if e._kpools))
    got = chip_smoke.phase_fleet_memory(torch.device("cpu"), 0, cycles=4)
    assert got["memory_allocated"] == [3 * mib64] * 4
    assert got["builds"] == 7 and not any(e._kpools for e in live)
