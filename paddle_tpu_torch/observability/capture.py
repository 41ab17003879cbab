"""Traffic capture — an always-on, bounded request recorder at gateway
admission, with trace fitting built on top.

The port's copy of ``paddle_tpu/observability/capture.py``.  Journeys
explain where one request's time went and perfscope where the device's
time went; capture answers "what traffic did this to us, and can we run
it again?":

* **recorder** — :class:`TrafficCapture` keeps one entry per request
  the gateway saw (admitted OR shed) in a ring bounded by
  ``PADDLE_TPU_CAPTURE_ENTRIES``, optionally spilling rotating JSONL
  files under ``PADDLE_TPU_CAPTURE_SPILL_DIR``.  The ring and the spill
  file live under ONE lock; the spill writer is a separate thread fed a
  bounded pending list, so admission never blocks on disk — overflow
  increments ``paddle_tpu_capture_dropped_total`` instead.
* **content modes** — ``shape`` (default) stores lengths plus a prompt
  hash and provably no token ids, so production capture never retains
  user content; ``full`` stores the exact prompt token ids for bitwise
  replay (``PADDLE_TPU_CAPTURE_MODE`` or the ``capture_mode`` knob on
  ``start_gateway``).
* **replay inputs** — every entry carries the request's sampling triple
  (temperature/top_k/seed), tenant/priority/model and arrival offset, so
  a captured window can be re-driven through the gateway: greedy
  requests reproduce token-identical output.
* **trace fitting** — :func:`fit_trace` estimates the windowed arrival
  rate curve (piecewise-constant; a flash crowd survives as a rate
  step, where a sinusoid fit would average it away) plus lognormal
  prompt/output length parameters and emits a synthetic trace in the
  JAX package's ``make_trace`` schema.
* **incident linkage** — the process-default capture registers a
  ``capture_tail`` section through ``watchdog.add_section``, so every
  crash bundle carries the last arrivals before it, each resolvable
  against ``/debug/requests`` by ``journey_id``.

Entry schema (one JSON-safe dict per request)::

    {t, tenant, priority, model, prompt_len, prompt_hash, max_tokens,
     deadline_s, temperature, top_k, seed, outcome, journey_id,
     conversation                     # raw id full mode, hash in shape
     [, prompt]}                      # token ids, full mode only

``t`` is seconds since the capture epoch (monotonic clock), so a window
replays with its inter-arrival times intact; ``outcome`` is
``admitted`` or the shed reason (``slo_shed``, ``draining``,
``tenant_queue_full``, ...).  Everything recorded is a host-side scalar
already on the admission path — no device reads, no host syncs.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import threading
import time
from collections import deque

import numpy as np

from . import flight, registry, watchdog

__all__ = ["TrafficCapture", "get_capture", "set_capture",
           "install_incident_section", "fit_params", "fit_trace",
           "CAPTURE_ENTRIES", "CAPTURE_DROPPED"]

# -- metric names (paddle_tpu_torch.observability registry) -------------------
CAPTURE_ENTRIES = "paddle_tpu_capture_entries_total"
CAPTURE_DROPPED = "paddle_tpu_capture_dropped_total"

MODES = ("shape", "full")
# how many tail arrivals ride in an incident bundle's capture_tail
_TAIL_N = max(4, int(os.environ.get("PADDLE_TPU_CAPTURE_TAIL", "32")))
# pending spill lines the writer may fall behind by before drops start
_PENDING_MAX = 4096


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, ""))
    except ValueError:
        return default


def _prompt_hash(ids, text) -> str:
    """Stable 64-bit content fingerprint: same prompt -> same hash, and
    (shape mode) nothing recoverable from it."""
    h = hashlib.blake2b(digest_size=8)
    if ids is not None:
        h.update(np.asarray(ids, np.int64).tobytes())
    elif text:
        h.update(str(text).encode("utf-8", "replace"))
    return h.hexdigest()


class TrafficCapture:
    """Bounded ring of admission-time request entries + optional
    rotating JSONL spill.

    Args:
        max_entries: ring bound (default ``PADDLE_TPU_CAPTURE_ENTRIES``,
            2048).  The ring NEVER exceeds it; spill-less evictions and
            a lagging spill writer count into ``capture_dropped_total``
            instead of blocking the recorder.
        mode: ``shape`` (default; lengths + hash, no token ids) or
            ``full`` (exact prompt ids for bitwise replay) — env default
            ``PADDLE_TPU_CAPTURE_MODE``.
        spill_dir: directory for the rotating JSONL spill (env default
            ``PADDLE_TPU_CAPTURE_SPILL_DIR``; None/"" disables).  Every
            recorded entry is appended to ``capture.jsonl`` by the
            writer thread; at ``spill_max_bytes`` the file rotates to
            ``capture.jsonl.1`` .. ``.{spill_files}``.
    """

    def __init__(self, max_entries: int | None = None,
                 mode: str | None = None, spill_dir: str | None = None,
                 spill_max_bytes: int | None = None, spill_files: int = 2):
        if max_entries is None:
            max_entries = _env_int("PADDLE_TPU_CAPTURE_ENTRIES", 2048)
        mode = (mode or os.environ.get("PADDLE_TPU_CAPTURE_MODE")
                or "shape").lower()
        if mode not in MODES:
            raise ValueError(f"capture mode must be one of {MODES}, "
                             f"got {mode!r}")
        if spill_dir is None:
            spill_dir = os.environ.get("PADDLE_TPU_CAPTURE_SPILL_DIR") or None
        if spill_max_bytes is None:
            spill_max_bytes = _env_int(
                "PADDLE_TPU_CAPTURE_SPILL_BYTES", 4 << 20)
        self.max_entries = max(1, int(max_entries))
        self.mode = mode
        self.spill_dir = spill_dir
        self.spill_max_bytes = max(1, int(spill_max_bytes))
        self.spill_files = max(1, int(spill_files))
        # ONE lock over the ring, the counters, the pending spill list
        # AND the spill file state (handle, size, rotation count): the
        # recorder and the writer thread share nothing outside it
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._ring: deque = deque()
        self._pending: list[str] = []
        self._recorded = 0
        self._dropped = 0
        self._spilled = 0
        self._rotations = 0
        self._epoch = time.perf_counter()
        self._file = None
        self._file_bytes = 0
        self._stop = False
        self._writer: threading.Thread | None = None

    # -- recording (gateway admission path) ----------------------------------
    def record(self, *, tenant: str, priority: str, outcome: str,
               prompt=None, text=None, prompt_len: int | None = None,
               max_tokens: int = 0, deadline_s: float | None = None,
               temperature: float = 0.0, top_k: int = 0, seed: int = 0,
               model: str | None = None, journey_id: str = "",
               conversation: str | None = None,
               t: float | None = None) -> dict:
        """Append one entry; never blocks on disk, never raises into
        admission.  ``prompt`` is the token-id sequence when the caller
        has one (stored only in ``full`` mode); ``t`` overrides the
        arrival offset for virtual-time feeds (bench/sim).
        ``conversation`` gets the prompt's privacy treatment: the raw id
        is stored only in ``full`` mode, ``shape`` mode keeps its hash —
        warm-turn grouping stays analyzable, the identifier does not
        leak."""
        ids = None if prompt is None else [int(x) for x in prompt]
        conv = None
        if conversation is not None:
            conv = (str(conversation) if self.mode == "full" else
                    hashlib.blake2b(str(conversation).encode("utf-8"),
                                    digest_size=8).hexdigest())
        entry = {
            "t": round(time.perf_counter() - self._epoch
                       if t is None else float(t), 4),
            "tenant": str(tenant),
            "priority": str(priority),
            "model": model,
            "prompt_len": int(len(ids) if ids is not None
                              else (prompt_len or 0)),
            "prompt_hash": _prompt_hash(ids, text),
            "max_tokens": int(max_tokens),
            "deadline_s": None if deadline_s is None else float(deadline_s),
            "temperature": float(temperature),
            "top_k": int(top_k),
            "seed": int(seed),
            "outcome": str(outcome),
            "journey_id": str(journey_id),
            "conversation": conv,
        }
        if self.mode == "full" and ids is not None:
            entry["prompt"] = ids
        line = (json.dumps(entry) + "\n") if self.spill_dir else None
        dropped = 0
        with self._cv:
            self._ring.append(entry)
            self._recorded += 1
            while len(self._ring) > self.max_entries:
                self._ring.popleft()
                if not self.spill_dir:
                    dropped += 1        # no spill: the entry is gone
            if line is not None:
                if len(self._pending) >= _PENDING_MAX:
                    dropped += 1        # writer lagging: shed the line
                else:
                    self._pending.append(line)
                    if self._writer is None or not self._writer.is_alive():
                        self._writer = threading.Thread(
                            target=self._spill_loop, daemon=True,
                            name="paddle-tpu-capture-spill")
                        self._writer.start()
                    self._cv.notify()
            self._dropped += dropped
        reg = registry()
        reg.counter(CAPTURE_ENTRIES, "captured gateway arrivals").inc(
            1.0, labels={"outcome": outcome})
        if dropped:
            reg.counter(CAPTURE_DROPPED,
                        "capture entries lost to ring/spill overflow").inc(
                float(dropped))
        return entry

    # -- spill writer thread -------------------------------------------------
    def _spill_loop(self):
        while True:
            with self._cv:
                while not self._pending and not self._stop:
                    self._cv.wait()
                batch, self._pending = self._pending, []
                stop = self._stop
                if batch:
                    try:
                        self._write_batch_locked(batch)
                    except OSError:
                        # a dead disk never kills capture: the ring
                        # stays authoritative, the lines are dropped
                        self._dropped += len(batch)
                self._cv.notify_all()   # wake flush() waiters
                if stop:
                    if self._file is not None:
                        try:
                            self._file.close()
                        except OSError:
                            pass
                        self._file = None
                    return

    def _write_batch_locked(self, lines: list[str]):
        # caller holds self._lock (the writer thread inside the CV)
        if self._file is None:
            os.makedirs(self.spill_dir, exist_ok=True)
            path = os.path.join(self.spill_dir, "capture.jsonl")
            self._file = open(path, "a", encoding="utf-8")
            self._file_bytes = self._file.tell()
        data = "".join(lines)
        self._file.write(data)
        self._file.flush()
        self._file_bytes += len(data)
        self._spilled += len(lines)
        if self._file_bytes >= self.spill_max_bytes:
            self._rotate_locked()

    def _rotate_locked(self):
        # caller holds self._lock
        self._file.close()
        self._file = None
        base = os.path.join(self.spill_dir, "capture.jsonl")
        for i in range(self.spill_files, 0, -1):
            src = base if i == 1 else f"{base}.{i - 1}"
            if os.path.exists(src):
                os.replace(src, f"{base}.{i}")
        self._rotations += 1
        self._file_bytes = 0
        flight.record("capture", "rotate", file=base,
                      rotation=self._rotations)

    def flush(self, timeout: float = 10.0) -> bool:
        """Block until the spill writer drained everything pending
        (True) or the timeout passed.  No-op without a spill dir."""
        if not self.spill_dir:
            return True
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._pending:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.notify()
                self._cv.wait(min(left, 0.25))
            if self._file is not None:
                try:
                    self._file.flush()
                except OSError:
                    pass
        return True

    def close(self):
        """Stop the writer (flushing what's pending) and close the
        spill file.  The ring stays readable."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
            writer = self._writer
        if writer is not None:
            writer.join(timeout=10)

    # -- query surfaces ------------------------------------------------------
    def entries(self, last: int | None = None, tenant: str | None = None,
                outcome: str | None = None,
                conversation: str | None = None) -> list[dict]:
        """Snapshot of the ring, oldest first, optionally filtered by
        tenant / outcome / conversation and tail-limited to ``last``.
        The ``conversation`` filter matches what was stored — the raw id
        in ``full`` mode, its hash in ``shape`` mode — and accepts
        either form (the raw id is re-hashed for the comparison)."""
        with self._lock:
            out = list(self._ring)
        if tenant is not None:
            out = [e for e in out if e["tenant"] == tenant]
        if outcome is not None:
            out = [e for e in out if e["outcome"] == outcome]
        if conversation is not None:
            want = {conversation,
                    hashlib.blake2b(str(conversation).encode("utf-8"),
                                    digest_size=8).hexdigest()}
            out = [e for e in out if e.get("conversation") in want]
        if last is not None:
            out = out[-max(0, int(last)):]
        return [dict(e) for e in out]

    def stats(self) -> dict:
        with self._lock:
            return {
                "mode": self.mode,
                "max_entries": self.max_entries,
                "entries": len(self._ring),
                "recorded": self._recorded,
                "dropped": self._dropped,
                "spill": None if not self.spill_dir else {
                    "dir": self.spill_dir,
                    "spilled": self._spilled,
                    "rotations": self._rotations,
                    "max_bytes": self.spill_max_bytes,
                },
            }

    def debug_state(self, last: int = 64, tenant: str | None = None,
                    outcome: str | None = None,
                    conversation: str | None = None) -> dict:
        """The ``GET /debug/capture`` payload."""
        out = self.stats()
        out["filtered"] = {"last": last, "tenant": tenant,
                          "outcome": outcome, "conversation": conversation}
        out["window"] = self.entries(last=last, tenant=tenant,
                                     outcome=outcome,
                                     conversation=conversation)
        return out

    def tail(self, n: int | None = None) -> dict:
        """The ``capture_tail`` incident-bundle section: the last N
        arrivals before the bundle was cut, with the per-tenant
        admit/shed mix.  Prompt ids never ride into a bundle — the tail
        is always shape-view, whatever the capture mode."""
        n = _TAIL_N if n is None else int(n)
        with self._lock:
            raw = list(self._ring)[-n:]
        entries = [{k: v for k, v in e.items() if k != "prompt"}
                   for e in raw]
        counts: dict[str, dict] = {}
        for e in entries:
            c = counts.setdefault(e["tenant"], {"admitted": 0, "shed": 0})
            c["admitted" if e["outcome"] == "admitted" else "shed"] += 1
        span = (round(entries[-1]["t"] - entries[0]["t"], 4)
                if len(entries) > 1 else 0.0)
        return {"mode": self.mode, "entries": entries, "counts": counts,
                "window_s": span}

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._recorded = 0
            self._dropped = 0


# -- process default ----------------------------------------------------------

_default_lock = threading.Lock()
_default: TrafficCapture | None = None


def install_incident_section(cap: TrafficCapture):
    """Make ``cap`` the source of the ``capture_tail`` section in every
    future crash bundle (the ``watchdog.add_section`` seam: every
    bundle ``watchdog.collect`` builds carries the section)."""
    watchdog.add_section("capture_tail", cap.tail)


def get_capture() -> TrafficCapture:
    """The process-default recorder (created on first use from the env
    knobs); every Gateway without explicit capture knobs records here."""
    global _default
    with _default_lock:
        if _default is None:
            _default = TrafficCapture()
            install_incident_section(_default)
        return _default


def set_capture(cap: TrafficCapture | None) -> TrafficCapture | None:
    """Swap the process default (tests; knob-built captures keep their
    gateway-local identity and don't go through here)."""
    global _default
    with _default_lock:
        _default = cap
        if cap is not None:
            install_incident_section(cap)
        return cap


# -- trace fitting ------------------------------------------------------------

def fit_params(entries, *, bin_s: float | None = None,
               duration_s: float | None = None) -> dict:
    """Estimate the traffic model behind a capture: a piecewise-constant
    windowed arrival-rate curve, lognormal prompt/output length
    parameters (MLE on the logs), the tenant mix, and — when the rate
    curve steps hard enough — the flash window.

    Works on shape-mode entries: only ``t``/``prompt_len``/
    ``max_tokens``/``tenant``/``deadline_s`` are read.
    """
    ts = sorted(float(e["t"]) for e in entries)
    if len(ts) < 2:
        raise ValueError(f"need >= 2 captured arrivals to fit a trace, "
                         f"got {len(ts)}")
    t0 = ts[0]
    duration = float(duration_s) if duration_s is not None else \
        (ts[-1] - t0) * (1.0 + 1.0 / len(ts))   # tail-corrected span
    duration = max(duration, 1e-6)
    if bin_s is None:
        bin_s = min(30.0, max(0.5, duration / 24.0))
    n_bins = max(1, int(math.ceil(duration / bin_s)))
    counts = [0] * n_bins
    for t in ts:
        counts[min(n_bins - 1, int((t - t0) / bin_s))] += 1
    bins = [{"t0": round(i * bin_s, 4), "t1": round((i + 1) * bin_s, 4),
             "qps": round(c / bin_s, 4)} for i, c in enumerate(counts)]

    def lognorm(values):
        logs = np.log(np.maximum(np.asarray(values, np.float64), 1.0))
        return {"mu": round(float(logs.mean()), 4),
                "sigma": round(float(logs.std()), 4),
                "p50": int(round(math.exp(float(logs.mean()))))}

    tenants: dict[str, int] = {}
    deadlines = []
    for e in entries:
        tenants[e.get("tenant") or ""] = tenants.get(
            e.get("tenant") or "", 0) + 1
        if e.get("deadline_s") is not None:
            deadlines.append(float(e["deadline_s"]))
    n = len(entries)
    rates = [b["qps"] for b in bins]
    base = float(np.median(rates))
    peak = max(rates)
    flash = None
    if base > 0 and peak >= 2.0 * base:
        # the flash window is the LONGEST consecutive run of hot bins
        # (>= 2x the median rate): with fine bins, Poisson noise makes
        # isolated bins hot — a first-to-last-hot-bin span would smear
        # the window across them
        best = run = None
        for b in bins:
            if b["qps"] >= 2.0 * base:
                run = [run[0], b] if run else [b, b]
                if best is None or (run[1]["t1"] - run[0]["t0"] >
                                    best[1]["t1"] - best[0]["t0"]):
                    best = list(run)
            else:
                run = None
        flash = {"t0": best[0]["t0"], "t1": best[1]["t1"],
                 "mult": round(peak / base, 2)}
    return {
        "arrivals": n,
        "duration_s": round(duration, 4),
        "bin_s": round(bin_s, 4),
        "bins": bins,
        "base_qps": round(base, 4),
        "peak_qps": round(peak, 4),
        "flash": flash,
        "prompt": lognorm([e["prompt_len"] for e in entries]),
        "out": lognorm([e["max_tokens"] for e in entries]),
        "tenants": {k: round(v / n, 4) for k, v in sorted(tenants.items())},
        "deadline_s": (round(float(np.median(deadlines)), 4)
                       if deadlines else None),
    }


def fit_trace(entries, *, seed: int = 0, bin_s: float | None = None,
              duration_s: float | None = None, prompt_max: int = 512,
              out_max: int = 256, params: dict | None = None) -> list:
    """Emit a ``make_trace``-compatible synthetic trace fitted to a
    capture: arrivals drawn by thinning against the capture's binned
    rate curve (the flash window survives as a rate step), lengths from
    the fitted lognormals, tenants from the measured mix.  Entries are
    ``{"t", "prompt_len", "max_tokens"[, "deadline_s"][, "tenant"]}`` —
    the schema the JAX package's ``FleetSim`` and
    ``load_gen.replay_http`` consume."""
    p = params if params is not None else fit_params(
        entries, bin_s=bin_s, duration_s=duration_s)
    rs = np.random.RandomState(seed)
    bins = p["bins"]
    bw = p["bin_s"]
    duration = p["duration_s"]
    rate_max = max(p["peak_qps"], 1e-6)

    def rate(t: float) -> float:
        return bins[min(len(bins) - 1, int(t / bw))]["qps"]

    tenant_names = [k for k in p["tenants"] if k]
    tenant_cdf = np.cumsum([p["tenants"][k] for k in tenant_names]) \
        if tenant_names else None
    trace = []
    t = 0.0
    while True:
        t += float(rs.exponential(1.0 / rate_max))
        if t >= duration:
            break
        if rs.uniform() * rate_max > rate(t):
            continue                     # thinned
        entry = {
            "t": round(t, 4),
            "prompt_len": int(np.clip(rs.lognormal(
                p["prompt"]["mu"], p["prompt"]["sigma"]), 1, prompt_max)),
            "max_tokens": int(np.clip(rs.lognormal(
                p["out"]["mu"], p["out"]["sigma"]), 1, out_max)),
        }
        if p["deadline_s"] is not None:
            entry["deadline_s"] = p["deadline_s"]
        if tenant_names:
            entry["tenant"] = tenant_names[int(
                np.searchsorted(tenant_cdf, rs.uniform() * tenant_cdf[-1]))]
        trace.append(entry)
    return trace
