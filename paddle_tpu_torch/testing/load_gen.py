"""Trace-driven load generator — diurnal + flash-crowd + heavy-tail.

The port's copy of ``tools/load_gen.py`` (numpy and the standard library
only): the same seeds give the same traces.  A Poisson-constant-QPS sweep
never exercises the autoscaler: real traffic has a daily swing,
step-function flash crowds, and heavy-tailed prompt/output lengths whose
long requests pin slots long after the arrival burst has passed.  This
module generates exactly that, seeded and deterministic:

* **arrivals** — a nonhomogeneous Poisson process (thinning): a
  sinusoidal diurnal swing (``base_qps * (1 + diurnal_amp * sin)``)
  with a step-function flash-crowd window pinning the rate to
  ``flash_mult * base_qps`` for ``flash_duration_s`` starting at
  ``flash_at`` of the trace — Black Friday in miniature.
* **lengths** — lognormal prompt and output token counts (heavy tail:
  p99/p50 of several x), clipped to the serving window.

The SAME trace drives both consumers:

* :class:`paddle_tpu_torch.serving.FleetSim` — virtual-time closed-loop
  simulation (policy evaluation on the CPU, the fleet-simulation blocks'
  attainment-vs-replica-seconds curves);
* this module's CLI — real HTTP load against a gateway::

      python -m paddle_tpu_torch.testing.load_gen \
          --url http://127.0.0.1:PORT --duration 30 --qps 4 \
          --flash-mult 6 --seed 0

  replays the trace wall-clock (one thread per in-flight request,
  bounded), then prints a JSON summary (completed/shed/error counts,
  client-measured TTFT percentiles, achieved QPS).
"""
from __future__ import annotations

import argparse
import http.client
import json
import math
import sys
import threading
import time

import numpy as np

__all__ = ["make_trace", "make_conversation_trace", "replay_http"]


def make_trace(duration_s: float = 60.0, base_qps: float = 4.0,
               seed: int = 0, *,
               diurnal_period_s: float | None = None,
               diurnal_amp: float = 0.4,
               flash_at: float = 0.5, flash_mult: float = 6.0,
               flash_duration_s: float = 8.0,
               prompt_mean: float = 16.0, prompt_sigma: float = 0.8,
               out_mean: float = 12.0, out_sigma: float = 0.7,
               prompt_max: int = 512, out_max: int = 256,
               deadline_s: float | None = None,
               adapters: list | None = None,
               adapter_skew: float = 0.8) -> list:
    """Seeded trace: [{"t", "prompt_len", "max_tokens"[, "deadline_s"]}].

    ``diurnal_period_s`` defaults to the trace duration (one full day's
    swing per trace); ``flash_at`` is the flash crowd's start as a
    fraction of the duration.  Lengths are lognormal around the given
    means — the p99 request is many times the p50, so a handful of
    requests dominate slot occupancy exactly like production.

    With ``adapters`` (LoRA adapter names), each entry carries a
    ``model`` field: the FIRST adapter gets ``adapter_skew`` of the
    traffic, the rest split the remainder uniformly — the skewed
    multi-adapter shape the router's locality tiebreak serves
    (``replay_http`` forwards ``model`` on the wire).
    """
    if duration_s <= 0 or base_qps <= 0:
        raise ValueError("duration_s and base_qps must be positive")
    rs = np.random.RandomState(seed)
    period = float(diurnal_period_s or duration_s)
    flash_t0 = flash_at * duration_s
    flash_t1 = flash_t0 + flash_duration_s

    def rate(t: float) -> float:
        # the flash crowd is a STEP to flash_mult x base — it overrides
        # the diurnal swing rather than compounding with it, so a
        # caller controls the overload depth exactly
        if flash_t0 <= t < flash_t1:
            return max(base_qps * flash_mult, 1e-6)
        return max(base_qps * (1.0 + diurnal_amp *
                               math.sin(2.0 * math.pi * t / period)), 1e-6)

    rate_max = base_qps * (1.0 + abs(diurnal_amp)) * max(1.0, flash_mult)
    trace = []
    t = 0.0
    while True:
        t += float(rs.exponential(1.0 / rate_max))
        if t >= duration_s:
            break
        if rs.uniform() * rate_max > rate(t):
            continue                     # thinned
        prompt_len = int(np.clip(
            rs.lognormal(math.log(prompt_mean), prompt_sigma), 1,
            prompt_max))
        max_tokens = int(np.clip(
            rs.lognormal(math.log(out_mean), out_sigma), 1, out_max))
        entry = {"t": round(t, 4), "prompt_len": prompt_len,
                 "max_tokens": max_tokens}
        if deadline_s is not None:
            entry["deadline_s"] = float(deadline_s)
        if adapters:
            if len(adapters) == 1 or rs.uniform() < adapter_skew:
                entry["model"] = adapters[0]
            else:
                entry["model"] = adapters[
                    1 + int(rs.randint(len(adapters) - 1))]
        trace.append(entry)
    return trace


def make_conversation_trace(duration_s: float = 60.0,
                            base_qps: float = 1.0, seed: int = 0, *,
                            turns_mean: float = 3.0, turns_max: int = 12,
                            think_mean_s: float = 2.0,
                            think_sigma: float = 0.6,
                            first_turn_mean: float = 24.0,
                            turn_mean: float = 8.0,
                            turn_sigma: float = 0.6,
                            out_mean: float = 8.0, out_sigma: float = 0.5,
                            prompt_max: int = 512, out_max: int = 128,
                            vocab: int = 1000,
                            deadline_s: float | None = None) -> list:
    """Seeded MULTI-TURN trace: conversations arrive Poisson at
    ``base_qps``; each runs a geometric number of turns (mean
    ``turns_mean``, capped ``turns_max``) separated by lognormal think
    times — the warm-turn shape the host prefix tier serves.

    Every entry carries explicit ``prompt`` token ids and a
    ``conversation`` id, and turn N+1's prompt EXTENDS turn N's — the
    user turn plus a seeded stand-in for the assistant reply are
    appended to the running history — so the prefix property that makes
    warm turns cheap holds by construction and the whole trace is
    reproducible from ``seed``.  Entries are ``replay_http``- and
    FleetSim-compatible (the superset schema: ``t``, ``prompt``,
    ``prompt_len``, ``max_tokens``, ``conversation``, ``turn``).  A
    conversation whose history would outgrow ``prompt_max`` simply
    ends early (the serving window is the real budget too).
    """
    if duration_s <= 0 or base_qps <= 0:
        raise ValueError("duration_s and base_qps must be positive")
    if turns_mean < 1.0:
        raise ValueError("turns_mean must be >= 1")
    rs = np.random.RandomState(seed)
    entries = []
    t = 0.0
    cidx = 0
    while True:
        t += float(rs.exponential(1.0 / base_qps))
        if t >= duration_s:
            break
        cidx += 1
        cid = f"conv-{seed}-{cidx}"
        n_turns = int(np.clip(rs.geometric(1.0 / turns_mean),
                              1, turns_max))
        first_len = int(np.clip(
            rs.lognormal(math.log(first_turn_mean), turn_sigma), 1,
            prompt_max))
        history = [int(x) for x in rs.randint(1, vocab, first_len)]
        tt = t
        for turn in range(n_turns):
            max_tokens = int(np.clip(
                rs.lognormal(math.log(out_mean), out_sigma), 1, out_max))
            if len(history) + max_tokens > prompt_max:
                break
            entry = {"t": round(tt, 4), "prompt": list(history),
                     "prompt_len": len(history),
                     "max_tokens": max_tokens,
                     "conversation": cid, "turn": turn}
            if deadline_s is not None:
                entry["deadline_s"] = float(deadline_s)
            entries.append(entry)
            # the stand-in reply + the next user turn extend the history
            # (a real client appends the ACTUAL reply; the stand-in
            # keeps the trace seed-reproducible — the shared prefix is
            # the previous PROMPT either way)
            reply = [int(x) for x in rs.randint(1, vocab, max_tokens)]
            user_len = int(np.clip(
                rs.lognormal(math.log(turn_mean), turn_sigma), 1,
                prompt_max))
            user = [int(x) for x in rs.randint(1, vocab, user_len)]
            history = history + reply + user
            tt += float(rs.lognormal(math.log(think_mean_s), think_sigma))
    entries.sort(key=lambda e: (e["t"], e["conversation"], e["turn"]))
    return entries


def replay_http(url: str, trace, *, vocab: int = 1000, seed: int = 0,
                tenant: str = "load", timeout_s: float = 600.0,
                max_in_flight: int = 256, speed: float = 1.0,
                collect_tokens: bool = False) -> dict:
    """Replay a trace against a live gateway, wall-clock-faithful: each
    entry fires at its ``t`` offset (late dispatch is recorded, never
    skipped).  Returns the client-side summary.

    Accepts both schemas: plain :func:`make_trace` output (synthetic
    prompts are drawn from ``seed``/``vocab``, one ``tenant`` for the
    whole run) AND the traffic-capture superset — per-entry ``prompt``
    (exact token ids, full-mode capture), ``tenant``, ``priority``,
    ``model``, ``temperature``/``top_k``/``seed``, so a captured window
    replays with its original attribution and sampling.  ``speed``
    compresses the inter-arrival clock (2.0 = twice as fast);
    ``collect_tokens`` adds per-request ``results`` (trace order, with
    the returned token ids) for determinism checks.
    """
    from urllib.parse import urlparse
    u = urlparse(url)
    host, port = u.hostname, u.port
    if speed <= 0:
        raise ValueError("speed must be positive")
    rs = np.random.RandomState(seed)
    # synthetic prompts draw from ONE stream in trace order, so a legacy
    # make_trace replay keeps its exact historical prompt sequence; a
    # captured entry's own ids always win
    prompts = [e.get("prompt")
               or [int(x) for x in rs.randint(1, vocab, e["prompt_len"])]
               for e in trace]
    out, lock = [], threading.Lock()
    gate = threading.Semaphore(max_in_flight)

    def one(i, entry, prompt):
        try:
            payload = {"prompt": prompt, "max_tokens": entry["max_tokens"]}
            if entry.get("deadline_s") is not None:
                payload["deadline_ms"] = int(entry["deadline_s"] * 1e3)
            for k in ("temperature", "top_k", "seed", "model", "priority",
                      "conversation"):
                if entry.get(k) is not None:
                    payload[k] = entry[k]
            conn = http.client.HTTPConnection(host, port,
                                              timeout=timeout_s)
            t0 = time.perf_counter()
            try:
                conn.request(
                    "POST", "/v1/completions", json.dumps(payload).encode(),
                    {"Content-Type": "application/json",
                     "X-Tenant": entry.get("tenant") or tenant})
                r = conn.getresponse()
                body = r.read()
                ttft = time.perf_counter() - t0   # blocking: full wall
                toks = (json.loads(body)["choices"][0]["token_ids"]
                        if r.status == 200 else [])
                rec = {"i": i, "status": r.status, "wall_s": ttft,
                       "tokens": len(toks)}
                if collect_tokens:
                    rec["token_ids"] = [int(x) for x in toks]
                with lock:
                    out.append(rec)
            finally:
                conn.close()
        except Exception as e:  # noqa: BLE001 — count as a failed sample
            with lock:
                out.append({"i": i, "status": -1, "wall_s": None,
                            "tokens": 0,
                            "error": f"{type(e).__name__}: {e}"})
        finally:
            gate.release()

    threads = []
    t_start = time.perf_counter()
    for i, (entry, prompt) in enumerate(zip(trace, prompts)):
        delay = entry["t"] / speed - (time.perf_counter() - t_start)
        if delay > 0:
            time.sleep(delay)
        gate.acquire()
        th = threading.Thread(target=one, args=(i, entry, prompt))
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=timeout_s)
    wall = time.perf_counter() - t_start
    walls = sorted(o["wall_s"] for o in out
                   if o["status"] == 200 and o["wall_s"] is not None)
    completed = sum(1 for o in out if o["status"] == 200)
    shed = sum(1 for o in out if o["status"] == 429)
    errors = [o for o in out if o["status"] not in (200, 429)]
    pct = (lambda q: round(float(np.percentile(walls, q)) * 1e3, 1)
           if walls else None)
    summary = {
        "requests": len(trace), "completed": completed, "shed": shed,
        "errors": len(errors),
        "achieved_qps": round(completed / wall, 2) if wall else 0.0,
        "tokens": sum(o["tokens"] for o in out),
        "wall_ms": {"p50": pct(50), "p99": pct(99)},
        "duration_s": round(wall, 2), "speed": speed,
    }
    if collect_tokens:
        summary["results"] = sorted(out, key=lambda o: o["i"])
    return summary


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--url", required=True,
                    help="gateway base URL (http://host:port)")
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--qps", type=float, default=4.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--diurnal-amp", type=float, default=0.4)
    ap.add_argument("--flash-at", type=float, default=0.5)
    ap.add_argument("--flash-mult", type=float, default=6.0)
    ap.add_argument("--flash-duration", type=float, default=8.0)
    ap.add_argument("--prompt-mean", type=float, default=16.0)
    ap.add_argument("--out-mean", type=float, default=12.0)
    ap.add_argument("--prompt-max", type=int, default=64)
    ap.add_argument("--out-max", type=int, default=32)
    ap.add_argument("--deadline-s", type=float, default=None)
    ap.add_argument("--adapters", default=None, metavar="A,B,...",
                    help="comma-separated LoRA adapter names: entries "
                    "carry model= with --adapter-skew of the traffic "
                    "on the first name")
    ap.add_argument("--adapter-skew", type=float, default=0.8)
    ap.add_argument("--tenant", default="load")
    ap.add_argument("--vocab", type=int, default=1000)
    ap.add_argument("--speed", type=float, default=1.0,
                    help="time-compression factor (2.0 = replay at 2x)")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="replay a saved trace/capture JSON (a list of "
                    "entries, or a /debug/capture dump) instead of "
                    "generating one")
    ap.add_argument("--conversations", action="store_true",
                    help="generate a multi-turn conversation trace "
                    "(make_conversation_trace) instead of independent "
                    "arrivals — exercises /v1/chat-style prefix reuse "
                    "via the `conversation` field")
    ap.add_argument("--turns-mean", type=float, default=3.0,
                    help="mean turns per conversation (--conversations)")
    args = ap.parse_args()
    if args.trace:
        with open(args.trace, encoding="utf-8") as f:
            trace = json.load(f)
        if isinstance(trace, dict):      # a /debug/capture dump
            trace = trace.get("window", [])
        if trace:                        # rebase: first arrival fires now
            t0 = min(e["t"] for e in trace)
            trace = [dict(e, t=round(e["t"] - t0, 4))
                     for e in sorted(trace, key=lambda e: e["t"])]
        print(f"# trace: {len(trace)} arrivals from {args.trace}",
              file=sys.stderr)
    elif args.conversations:
        trace = make_conversation_trace(
            args.duration, args.qps, args.seed,
            turns_mean=args.turns_mean,
            first_turn_mean=args.prompt_mean, turn_mean=args.out_mean,
            out_mean=args.out_mean, prompt_max=args.prompt_max,
            out_max=args.out_max, vocab=args.vocab,
            deadline_s=args.deadline_s)
        n_conv = len({e["conversation"] for e in trace})
        print(f"# trace: {len(trace)} turns across {n_conv} "
              f"conversations over {args.duration}s", file=sys.stderr)
    else:
        trace = make_trace(
            args.duration, args.qps, args.seed,
            diurnal_amp=args.diurnal_amp, flash_at=args.flash_at,
            flash_mult=args.flash_mult,
            flash_duration_s=args.flash_duration,
            prompt_mean=args.prompt_mean, out_mean=args.out_mean,
            prompt_max=args.prompt_max, out_max=args.out_max,
            deadline_s=args.deadline_s,
            adapters=(args.adapters.split(",") if args.adapters
                      else None),
            adapter_skew=args.adapter_skew)
        print(f"# trace: {len(trace)} arrivals over {args.duration}s "
              f"(flash x{args.flash_mult} at {args.flash_at:.0%})",
              file=sys.stderr)
    summary = replay_http(args.url, trace, vocab=args.vocab,
                          seed=args.seed, tenant=args.tenant,
                          speed=args.speed)
    print(json.dumps(summary))
    return 0 if summary["errors"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
