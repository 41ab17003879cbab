"""Step-level training metrics: latency, throughput, device memory, and
the input pipeline's counters.

The port's copy of ``paddle_tpu/observability/steps.py``.  Fed by the
train step (``distributed/spmd.py``), the hapi ``TelemetryCallback``,
the ``DevicePrefetcher`` (``io/prefetch.py``) and anything else that
owns a step boundary.  Host latency on an asynchronous device measures
dispatch, not device time, but a dispatch-bound loop is exactly the
pathology worth seeing, and on a steady synced loop the two converge.
"""
from __future__ import annotations

import torch

from . import registry

STEP_LATENCY = "paddle_tpu_step_latency_seconds"
STEPS_TOTAL = "paddle_tpu_steps_total"
EXAMPLES_TOTAL = "paddle_tpu_examples_total"
EXAMPLES_PER_SEC = "paddle_tpu_examples_per_sec"
MEMORY_GAUGE = "paddle_tpu_device_memory_bytes"
# input-pipeline metrics (io/prefetch.py DevicePrefetcher)
HOST_INPUT_WAIT = "paddle_tpu_host_input_wait_seconds_total"
PREFETCH_DEPTH = "paddle_tpu_prefetch_buffer_depth"
PREFETCH_BATCHES = "paddle_tpu_prefetch_batches_total"
PIPELINE_STALLS = "paddle_tpu_pipeline_stalls_total"


def record_step(seconds: float, examples: int | None = None,
                fn: str = "train_step"):
    reg = registry()
    labels = {"fn": fn}
    reg.histogram(STEP_LATENCY, "host wall-time per train step").observe(
        seconds, labels=labels)
    reg.counter(STEPS_TOTAL, "train steps dispatched").inc(1.0, labels=labels)
    if examples is not None:
        reg.counter(EXAMPLES_TOTAL, "examples consumed").inc(
            float(examples), labels=labels)
        if seconds > 0:
            reg.gauge(EXAMPLES_PER_SEC,
                      "instantaneous examples/s of the last step").set(
                examples / seconds, labels=labels)


def memory_stats(device=0) -> dict:
    """The CUDA caching allocator's counters of ``device`` under the JAX
    package's names (``{}`` without a card): ``bytes_in_use``,
    ``peak_bytes_in_use``, ``largest_alloc_size`` (torch's
    ``memory_stats``) and ``bytes_limit`` (``mem_get_info``'s total)."""
    if not torch.cuda.is_available():
        return {}
    st = torch.cuda.memory_stats(device)
    out = {}
    for key, name in (("bytes_in_use", "allocated_bytes.all.current"),
                      ("peak_bytes_in_use", "allocated_bytes.all.peak"),
                      ("largest_alloc_size", "requested_bytes.all.peak")):
        if name in st:
            out[key] = int(st[name])
    out["bytes_limit"] = int(torch.cuda.mem_get_info(device)[1])
    return out


def record_memory_stats():
    """Snapshot :func:`memory_stats` as gauges (absent on the CPU, as the
    JAX package's are)."""
    try:
        stats = memory_stats(0)
    except Exception:  # noqa: BLE001 — a telemetry read never fails a step
        return
    if not stats:
        return
    g = registry().gauge(MEMORY_GAUGE, "CUDA allocator stats, device 0")
    for key in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit",
                "largest_alloc_size"):
        if key in stats:
            g.set(float(stats[key]), labels={"stat": key})


def record_input_wait(seconds: float, fn: str = "prefetch"):
    """Time the train loop spent blocked waiting for the next device-ready
    batch (DevicePrefetcher found its buffer empty)."""
    registry().counter(
        HOST_INPUT_WAIT,
        "train-loop wall-time blocked on host input").inc(
        max(0.0, float(seconds)), labels={"fn": fn})


def set_prefetch_depth(depth: int, fn: str = "prefetch"):
    registry().gauge(
        PREFETCH_DEPTH,
        "DevicePrefetcher buffer occupancy (device-resident batches)").set(
        float(depth), labels={"fn": fn})


def record_prefetch_batch(fn: str = "prefetch"):
    registry().counter(
        PREFETCH_BATCHES,
        "batches delivered by DevicePrefetcher").inc(1.0, labels={"fn": fn})


def record_pipeline_stall(fn: str = "prefetch"):
    registry().counter(
        PIPELINE_STALLS,
        "warm-buffer underruns (device waited on host input)").inc(
        1.0, labels={"fn": fn})


def step_latency_count(fn: str = "train_step") -> int:
    h = registry().get(STEP_LATENCY)
    return h.count(labels={"fn": fn}) if h is not None else 0
