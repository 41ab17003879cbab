"""Device perfscope — per-program device time and MFU attribution, and the
device memory ownership ledger.

The port's counterpart of ``paddle_tpu/observability/perfscope.py``, with
the metric names, the report shapes and the ledger API of the JAX module,
re-expressed for a CUDA card in four ways:

**The sampled device timer is a pair of CUDA events.**  With
``PADDLE_TPU_PERFSCOPE_SAMPLE=N`` (or :func:`set_sample_every`), every
Nth dispatch of a program is timed: the serving engine records an event
before and after its decode graph's replay on the engine's stream; the
step already ends in one device-to-host copy of the tokens, and the
events are read after that copy, so sampling adds no wait.  The wait on
the sampled step goes through :func:`block_ready` (module level, so the
tests can count it); the other ``N - 1`` dispatches never reach it.  On
the CPU the forward is synchronous and the sample is its host wall.

**The cost of each signature is worked out from the shapes** when it is
registered (the engine does so when it captures its decode graph): the
GEMMs' operations from the parameter count and the rows, the attention
read from the paged kernel's :func:`~paddle_tpu_torch.kernels.
paged_attention.paged_cost`.  A sampled dispatch may carry the cost of
what its own data needs (the rows' real lengths, which the host holds).
XLA's ``cost_analysis`` has no counterpart here.

**Peaks come from a table keyed by** ``torch.cuda.get_device_name``: the
H100 SXM's data-sheet rates (989 TFLOP/s dense bf16 and fp16, 67 TFLOP/s
f32, 3.35 TB/s); without a card a SYNTHETIC cpu entry (1 TFLOP/s, 100 GB/s,
the JAX package's cpu row) keeps the MFU arithmetic testable on the CPU.
A card the table does not name gives no MFU.  There is no TPU entry.

**The ledger reconciles against** ``torch.cuda.memory_allocated``.
Long-lived device allocations declare a named owner (``weights``,
``kv_pool``, ``adapter_bank``, and ``prefix_cache`` — a *nested*
sub-account of the pool bytes): ``ledger().register(owner, nbytes)``
returns a row with ``update`` / ``add`` / ``release``; per-owner sums
export as ``paddle_tpu_hbm_bytes{owner}`` (telemetry on), and
:func:`memory_report` (``GET /debug/memory``) reconciles them against the
allocator's bytes in use with an explicit ``unattributed`` remainder.
:func:`note_exception` recognises torch's ``OutOfMemoryError``, records an
``oom`` flight event with the owner table and writes one watchdog bundle
whose ``hbm_ledger`` section carries the ledger.

Exported series (telemetry on):

* ``paddle_tpu_device_program_seconds{program}`` — sampled device
  seconds (counter),
* ``paddle_tpu_device_program_mfu{program}`` — model-flops utilization
  of the last sampled dispatch (gauge),
* ``paddle_tpu_device_program_hbm_bw_frac{program}`` — fraction of peak
  memory bandwidth (gauge),
* ``paddle_tpu_hbm_bytes{owner}`` — the ledger's owners (gauge),

plus :func:`perf_report` (``GET /debug/perf``) and :func:`chrome_events`
(sampled intervals as a ``"cat": "device"`` lane).
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque

import torch

from . import flight, registry, steps
from .steps import MEMORY_GAUGE  # noqa: F401 — re-exported

logger = logging.getLogger("paddle_tpu_torch.observability")

# -- metric names --------------------------------------------------------------
DEVICE_PROGRAM_SECONDS = "paddle_tpu_device_program_seconds"
DEVICE_PROGRAM_MFU = "paddle_tpu_device_program_mfu"
DEVICE_PROGRAM_BW_FRAC = "paddle_tpu_device_program_hbm_bw_frac"
HBM_BYTES = "paddle_tpu_hbm_bytes"

# ledger owners whose bytes live in host DRAM, not on the device: part of
# the consolidated KV budget, excluded from the allocator reconciliation
HOST_OWNERS = frozenset({"host_prefix"})

# peak rates by device: (substring of torch.cuda.get_device_name,
# {dtype: dense FLOP/s}, memory bytes/s) — NVIDIA's data sheet for the
# SXM part, which names itself "H100 80GB HBM3" (a PCIe or NVL card has
# other rates and no row: it gets no MFU)
_H100_SXM = ({"bfloat16": 989e12, "float16": 989e12, "float32": 67e12},
             3.35e12)
PEAK_TABLE = (("H100 80GB HBM3",) + _H100_SXM, ("H100 SXM",) + _H100_SXM)
# the synthetic cpu entry (the JAX package's cpu spec row): it exists so
# the arithmetic runs on the CPU, not to describe any real host
CPU_PEAK = ({"bfloat16": 1e12, "float16": 1e12, "float32": 1e12}, 100e9)

_lock = threading.Lock()

# sample every Nth dispatch per program; 0 = sampling off (the default:
# the hot path then costs one integer compare per dispatch)
_SAMPLE = [max(0, int(os.environ.get("PADDLE_TPU_PERFSCOPE_SAMPLE",
                                     "0") or 0))]
# sampled program intervals (the cat:"device" chrome lane)
_RING: deque = deque(
    maxlen=max(16, int(os.environ.get("PADDLE_TPU_PERFSCOPE_RING", "2048"))))
# ({dtype: peak FLOP/s}, peak bytes/s) — resolved lazily from the table
_peaks: list = [None]


def sample_every() -> int:
    return _SAMPLE[0]


def set_sample_every(n: int):
    """Sample one in every ``n`` dispatches per program (0 disables)."""
    _SAMPLE[0] = max(0, int(n))


def sampling_active() -> bool:
    return _SAMPLE[0] > 0


def _telemetry_on() -> bool:
    from . import enabled
    return enabled()


# -- peaks ---------------------------------------------------------------------

def peaks_for(device_name: str | None) -> tuple:
    """``({dtype: FLOP/s}, bytes/s)`` for a device name: the table row
    whose key the name contains, the synthetic cpu entry for None, and
    no peaks (``({}, 0.0)``) for a card the table does not name."""
    if device_name is None:
        return CPU_PEAK
    for key, flops, bw in PEAK_TABLE:
        if key in device_name:
            return flops, bw
    return {}, 0.0


def _resolve():
    p = _peaks[0]
    if p is None:
        name = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
                else None)
        p = _peaks[0] = peaks_for(name)
    return p


def peaks(dtype: str = "bfloat16") -> tuple:
    """(peak FLOP/s for ``dtype``, peak memory bytes/s) of this process's
    device (card 0, or the synthetic cpu entry without a card)."""
    flops, bw = _resolve()
    return float(flops.get(dtype, 0.0)), float(bw)


def set_peaks(flops: float, hbm_bw: float):
    """Pin the peaks, one FLOP/s rate for every dtype (tests / an explicit
    hardware description)."""
    f = float(flops)
    _peaks[0] = ({"bfloat16": f, "float16": f, "float32": f}, float(hbm_bw))


def reset_peaks():
    _peaks[0] = None


# -- per-program accounting ----------------------------------------------------

class _ProgramStats:
    __slots__ = ("name", "costs", "dispatches", "sampled",
                 "device_seconds", "sampled_flops", "sampled_bytes", "last")

    def __init__(self, name: str):
        self.name = name
        self.costs: dict = {}        # signature key -> {"flops", "bytes"...}
        self.dispatches = 0
        self.sampled = 0
        self.device_seconds = 0.0
        self.sampled_flops = 0.0     # the sampled dispatches' own costs
        self.sampled_bytes = 0.0
        self.last: dict | None = None


_programs: dict[str, _ProgramStats] = {}


def _program(name: str) -> _ProgramStats:
    st = _programs.get(name)
    if st is None:
        st = _programs[name] = _ProgramStats(name)
    return st


def poll_sample(program: str) -> bool:
    """Count one dispatch of ``program``; True when THIS dispatch should
    be timed (every ``sample_every()``-th).  Callers only invoke this
    while :func:`sampling_active`."""
    n = _SAMPLE[0]
    with _lock:
        st = _program(program)
        st.dispatches += 1
        return n > 0 and st.dispatches % n == 0


def register_cost(program: str, key, cost: dict):
    """Book one signature's cost (``flops``, ``bytes accessed`` and the
    ``dtype`` whose peak applies; called once per signature)."""
    with _lock:
        _program(program).costs[str(key)[:256]] = {
            "flops": float(cost.get("flops", 0.0) or 0.0),
            "bytes": float(cost.get("bytes accessed", 0.0) or 0.0),
            "dtype": str(cost.get("dtype", "bfloat16")),
        }


def block_ready(x):
    """The sampling barrier (module-level so tests can count calls): wait
    for a CUDA event, or for the stream of a CUDA tensor; a CPU tensor is
    ready already."""
    if isinstance(x, torch.cuda.Event):
        x.synchronize()
    elif isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()


def record_sample(program: str, key, seconds: float, cost: dict | None = None):
    """Book one sampled dispatch of ``seconds`` device time (CUDA events;
    host wall on the CPU).  ``cost`` (``flops``, ``bytes accessed``) is
    the work of this dispatch's own data where the caller knows it, else
    the signature's registered cost applies.  Updates the roofline
    stats, the device-lane ring, and (telemetry on) the exported series."""
    seconds = max(float(seconds), 1e-12)
    with _lock:
        st = _program(program)
        reg = st.costs.get(str(key)[:256]) or {}
        if cost is not None:
            flops = float(cost.get("flops", 0.0) or 0.0)
            bts = float(cost.get("bytes accessed", 0.0) or 0.0)
            st.sampled_flops += flops
            st.sampled_bytes += bts
        else:
            flops, bts = reg.get("flops", 0.0), reg.get("bytes", 0.0)
        pf, pb = peaks(reg.get("dtype", "bfloat16"))
        st.sampled += 1
        st.device_seconds += seconds
        mfu = (flops / (seconds * pf)) if flops and pf else None
        bw = (bts / (seconds * pb)) if bts and pb else None
        st.last = {"seconds": seconds, "mfu": mfu, "bw_frac": bw,
                   "flops": flops, "bytes": bts}
        _RING.append({"program": program, "ts": time.perf_counter() * 1e6,
                      "dur": seconds * 1e6, "mfu": mfu, "bw_frac": bw,
                      "flops": flops, "bytes": bts})
    if _telemetry_on():
        reg = registry()
        reg.counter(DEVICE_PROGRAM_SECONDS,
                    "sampled device seconds per compiled program").inc(
            seconds, labels={"program": program})
        if mfu is not None:
            reg.gauge(DEVICE_PROGRAM_MFU,
                      "model-flops utilization of the last sampled "
                      "dispatch").set(mfu, labels={"program": program})
        if bw is not None:
            reg.gauge(DEVICE_PROGRAM_BW_FRAC,
                      "fraction of peak HBM bandwidth of the last "
                      "sampled dispatch").set(bw, labels={"program": program})


def program_stats(program: str) -> dict | None:
    """One program's accounting as plain data (None when never seen)."""
    with _lock:
        st = _programs.get(program)
        if st is None:
            return None
        return {"program": st.name, "signatures": len(st.costs),
                "dispatches": st.dispatches, "sampled": st.sampled,
                "device_seconds": st.device_seconds,
                "costs": dict(st.costs), "last": dict(st.last or {})}


def perf_report() -> dict:
    """The ``GET /debug/perf`` roofline table: one row per program with
    dispatch/sample counts, sampled device time, the estimated total
    (mean sampled dt x dispatches), its share of the estimated total, and
    the MFU / memory-bandwidth fractions — of the sampled dispatches' own
    mean cost where they carried one, else of the largest registered
    signature's."""
    pf0, pb = peaks()
    rows = []
    with _lock:
        for st in list(_programs.values()):
            mean_dt = (st.device_seconds / st.sampled) if st.sampled else None
            est = (mean_dt * max(st.dispatches, st.sampled)
                   if mean_dt is not None else None)
            sig = max(st.costs.values(), key=lambda c: c["flops"],
                      default={"flops": 0.0, "bytes": 0.0,
                               "dtype": "bfloat16"})
            if st.sampled and st.sampled_flops:
                flops = st.sampled_flops / st.sampled
                nbytes = st.sampled_bytes / st.sampled
            else:
                flops, nbytes = sig["flops"], sig["bytes"]
            pf, _ = peaks(sig["dtype"])
            mfu = (flops / (mean_dt * pf)
                   if mean_dt and flops and pf else None)
            bw = (nbytes / (mean_dt * pb)
                  if mean_dt and nbytes and pb else None)
            rows.append({
                "program": st.name, "signatures": len(st.costs),
                "dispatches": st.dispatches, "sampled": st.sampled,
                "device_s": round(st.device_seconds, 6),
                "est_total_s": None if est is None else round(est, 6),
                "flops": flops, "bytes": nbytes, "dtype": sig["dtype"],
                "peak_flops": pf,
                "mfu": None if mfu is None else round(mfu, 6),
                "hbm_bw_frac": None if bw is None else round(bw, 6),
                "last": dict(st.last) if st.last else None,
            })
    total_est = sum(r["est_total_s"] or 0.0 for r in rows)
    for r in rows:
        r["share"] = (round((r["est_total_s"] or 0.0) / total_est, 4)
                      if total_est > 0 else 0.0)
    rows.sort(key=lambda r: -(r["est_total_s"] or 0.0))
    return {"sample_every": _SAMPLE[0], "peak_flops": pf0,
            "peak_hbm_bw": pb, "programs": rows}


def chrome_events() -> list[dict]:
    """Sampled program intervals as chrome-trace 'X' events on the SAME
    perf_counter*1e6 clock base as ``trace.chrome_events`` and the
    journey tracks, ``"cat": "device"`` — one lane per program."""
    pid = os.getpid()
    with _lock:
        samples = list(_RING)
    out = []
    for s in samples:
        args = {k: s[k] for k in ("mfu", "bw_frac", "flops", "bytes")
                if s[k] is not None}
        out.append({"name": s["program"], "ph": "X",
                    "ts": s["ts"] - s["dur"], "dur": s["dur"], "pid": pid,
                    "tid": f"device:{s['program']}", "cat": "device",
                    "args": args})
    return out


def reset_programs():
    """Drop program stats + the device-lane ring (tests).  The ledger is
    NOT touched — its rows mirror live allocations."""
    with _lock:
        _programs.clear()
        _RING.clear()


# -- the device memory ownership ledger ----------------------------------------

class LedgerRow:
    """One owned long-lived device allocation.  ``nested`` rows are
    informational sub-accounts of bytes already counted by a top-level
    owner (prefix-cache pages inside the KV pool) — they never contribute
    to the ledger total."""

    __slots__ = ("owner", "detail", "nbytes", "nested", "_ledger",
                 "_released")

    def __init__(self, ledger, owner: str, nbytes: int, detail, nested):
        self.owner = str(owner)
        self.detail = detail
        self.nbytes = max(0, int(nbytes))
        self.nested = bool(nested)
        self._ledger = ledger
        self._released = False

    @property
    def released(self) -> bool:
        return self._released

    def update(self, nbytes: int):
        """Set this row's byte count (in-place resize)."""
        self._ledger._set(self, max(0, int(nbytes)))

    def add(self, delta: int):
        """Adjust this row's byte count by ``delta`` (clamped at 0)."""
        self._ledger._add(self, int(delta))

    def release(self):
        """Drop the row (the allocation was freed).  Idempotent."""
        self._ledger._release(self)


class HbmLedger:
    """Registry of named long-lived device allocations (see the module
    doc).  Always on; one lock-guarded update per register / update /
    release — never per dispatch."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rows: list[LedgerRow] = []
        self.registered_total = 0       # rows ever registered
        self.released_total = 0

    def register(self, owner: str, nbytes: int = 0, detail=None,
                 nested: bool = False) -> LedgerRow:
        row = LedgerRow(self, owner, nbytes, detail, nested)
        with self._lock:
            self._rows.append(row)
            self.registered_total += 1
        self._export(row.owner, row.nested)
        return row

    # -- row plumbing --------------------------------------------------------
    def _set(self, row: LedgerRow, nbytes: int):
        with self._lock:
            if row._released:
                return
            row.nbytes = nbytes
        self._export(row.owner, row.nested)

    def _add(self, row: LedgerRow, delta: int):
        with self._lock:
            if row._released:
                return
            row.nbytes = max(0, row.nbytes + delta)
        self._export(row.owner, row.nested)

    def _release(self, row: LedgerRow):
        with self._lock:
            if row._released:
                return
            row._released = True
            self._rows.remove(row)
            self.released_total += 1
        self._export(row.owner, row.nested)

    def _export(self, owner: str, nested: bool):
        """Refresh the owner's gauge after any row change (telemetry on);
        nested owners export too — their gauge is the sub-account."""
        if not _telemetry_on():
            return
        with self._lock:
            total = sum(r.nbytes for r in self._rows if r.owner == owner)
        registry().gauge(
            HBM_BYTES,
            "device bytes held per declared owner (HBM ledger)").set(
            float(total), labels={"owner": owner})

    # -- reading -------------------------------------------------------------
    def owner_bytes(self) -> dict:
        """{owner: bytes} over top-level rows (the partition that sums
        to :meth:`total`)."""
        out: dict[str, int] = {}
        with self._lock:
            for r in self._rows:
                if not r.nested:
                    out[r.owner] = out.get(r.owner, 0) + r.nbytes
        return out

    def nested_bytes(self) -> dict:
        out: dict[str, int] = {}
        with self._lock:
            for r in self._rows:
                if r.nested:
                    out[r.owner] = out.get(r.owner, 0) + r.nbytes
        return out

    def total(self) -> int:
        with self._lock:
            return sum(r.nbytes for r in self._rows if not r.nested)

    def rows(self) -> list[dict]:
        with self._lock:
            return [{"owner": r.owner, "bytes": r.nbytes,
                     "nested": r.nested, "detail": r.detail}
                    for r in self._rows]

    def snapshot(self) -> dict:
        """JSON-safe ledger state (the watchdog bundle section and the
        OOM flight payload)."""
        return {"owners": self.owner_bytes(), "nested": self.nested_bytes(),
                "total": self.total(), "rows": self.rows(),
                "registered_total": self.registered_total,
                "released_total": self.released_total}


_LEDGER = HbmLedger()


def ledger() -> HbmLedger:
    """The process-wide device memory ownership ledger (always usable)."""
    return _LEDGER


def backend_memory() -> dict:
    """The CUDA caching allocator's view of card 0 (``{}`` without a
    card): ``bytes_in_use`` is ``torch.cuda.memory_allocated``."""
    if not torch.cuda.is_available():
        return {}
    return {"bytes_in_use": int(torch.cuda.memory_allocated(0)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(0)),
            "bytes_reserved": int(torch.cuda.memory_reserved(0)),
            "bytes_limit": int(torch.cuda.get_device_properties(0)
                               .total_memory)}


def record_memory_stats():
    """The allocator's numbers as ``paddle_tpu_device_memory_bytes{stat}``
    gauges (``steps.record_memory_stats``; absent without a card, as the
    JAX package's are on the CPU)."""
    steps.record_memory_stats()


def memory_report() -> dict:
    """The ``GET /debug/memory`` JSON: per-owner bytes, the tracked
    total, the allocator's view, and the unattributed remainder (bytes in
    use the ledger cannot name — the decode graphs' private pools,
    activations, the cuBLAS workspaces)."""
    led = ledger()
    owners = led.owner_bytes()
    total = sum(owners.values())
    device_total = total - sum(owners.get(o, 0) for o in HOST_OWNERS)
    backend = backend_memory()
    out = {"owners": owners, "nested": led.nested_bytes(),
           "total_tracked": total, "backend": backend,
           "rows": led.rows()}
    if "bytes_in_use" in backend:
        out["unattributed"] = int(backend["bytes_in_use"]) - device_total
    return out


# -- OOM forensics -------------------------------------------------------------

_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory")
_oom_dumped: set = set()


def looks_like_oom(exc: BaseException) -> bool:
    if isinstance(exc, torch.OutOfMemoryError):
        return True
    text = f"{type(exc).__name__}: {exc}"
    return any(m in text for m in _OOM_MARKERS)


def note_exception(exc: BaseException, program: str = "") -> bool:
    """Allocation-failure forensics: when ``exc`` is a device OOM, record
    an ``oom`` flight event carrying the owner table and write ONE
    watchdog bundle per program (its ``hbm_ledger`` section holds the
    full ledger).  Returns whether the exception matched."""
    if not looks_like_oom(exc):
        return False
    snap = ledger().snapshot()
    flight.record("oom", program or "device",
                  error=f"{type(exc).__name__}: {str(exc)[:512]}",
                  total_tracked=snap["total"],
                  owners=json.dumps(snap["owners"]))
    logger.warning(
        "paddle_tpu_torch perfscope: %s",
        json.dumps({"event": "out_of_memory",
                    "program": program or None,
                    "owners": snap["owners"],
                    "total_tracked": snap["total"],
                    "hint": "device OOM — the hbm_ledger section of the "
                            "crash bundle names who holds the bytes; "
                            "see GET /debug/memory on a live server"}))
    if program not in _oom_dumped:
        _oom_dumped.add(program)
        from . import watchdog
        watchdog.dump(f"resource_exhausted:{program or 'device'}")
    return True


def reset_oom_dumps():
    """Re-arm the one-bundle-per-program guard (tests)."""
    _oom_dumped.clear()


# the crash bundle carries the ledger: an OOM artifact names its owners
from . import watchdog as _watchdog  # noqa: E402

_watchdog.add_section("hbm_ledger", lambda: ledger().snapshot())
