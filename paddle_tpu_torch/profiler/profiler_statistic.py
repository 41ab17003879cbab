"""Summary tables (the port's copy of
``paddle_tpu/profiler/profiler_statistic.py``; reference:
python/paddle/profiler/profiler_statistic.py)."""
from __future__ import annotations

from collections import defaultdict
from enum import Enum


class SortedKeys(Enum):
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5


def build_summary(events, step_times, time_unit="ms") -> str:
    scale = {"s": 1e-6, "ms": 1e-3, "us": 1.0}[time_unit]
    stats = defaultdict(lambda: {"count": 0, "total": 0.0, "max": 0.0,
                                 "min": float("inf")})
    for e in events:
        s = stats[e["name"]]
        s["count"] += 1
        s["total"] += e["dur"]
        s["max"] = max(s["max"], e["dur"])
        s["min"] = min(s["min"], e["dur"])

    width = 78
    lines = ["-" * width,
             f"{'Name':<34}{'Calls':>7}{'Total(' + time_unit + ')':>13}"
             f"{'Avg(' + time_unit + ')':>12}{'Max(' + time_unit + ')':>12}",
             "=" * width]
    for name, s in sorted(stats.items(), key=lambda kv: -kv[1]["total"]):
        lines.append(
            f"{name[:33]:<34}{s['count']:>7}{s['total'] * scale:>13.4f}"
            f"{s['total'] / s['count'] * scale:>12.4f}"
            f"{s['max'] * scale:>12.4f}")
    if step_times:
        total = sum(step_times) * 1e6 * scale
        lines.append("=" * width)
        lines.append(f"steps: {len(step_times)}  total: {total:.4f} "
                     f"{time_unit}")
    lines.append("-" * width)
    return "\n".join(lines)
