#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card and fails without one.  Phases, in order (any failure ends the
run with a non-zero exit, and nothing is caught):

1. the card: ``nvidia-smi`` name and power limit, device name and count;
2. build the CUDA kernels from ``paddle_tpu_torch/kernels/csrc`` with
   ``nvcc`` (seconds, plus the ``-Xptxas -v`` register/shared-memory
   report);
3. hold each kernel against its plain PyTorch version at the serving
   path's shapes, TF32 off, and time kernel, plain version, the bound
   (the larger of f32 flops / 67 TFLOP/s and bytes / 3.35 TB/s, H100 SXM
   data sheet) and, for flash attention, PyTorch's
   ``scaled_dot_product_attention`` as a yardstick the port never calls;
4. serve: ``gpt2-small-en`` at full width with random weights made from a
   numpy seed and loaded through ``load_jax_state``; ``Engine(max_slots=8,
   max_len=640, paged_kv=True, page_size=16)``; 24 requests (prompts of
   32-128 tokens and one of 512, 32 new tokens each) from a background
   thread; the launch counters, set to 0 just before, must equal prefill
   batches x 12 (flash) and decode steps x 12 (paged);
5. teacher forcing: every served token's logit under the plain no-cache
   forward on the CPU (same weights, over ``prompt + generated[:-1]``)
   lies within 1e-3 of that position's maximum;
6. where the time goes: 8 more requests on the f32 engine (after the
   launch counters are read) under ``torch.profiler``: the device's busy
   share of the window and device time by kernel;
7. the same serving checks with ``kv_dtype="int8"`` pools, a shorter run,
   margin 2e-2;
8. tokens/s, p50 time to first token and peak device memory.

Prints ``{"kernels": [...]}`` and the ``nvidia-smi`` line before the last
line, which is ``{"ok": true, "device": {...}}``.  ``--out PATH`` also
writes every measured number as JSON, and the profiled window's chrome
trace beside it.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

N_LAYERS = 12
F32_PEAK = 67e12          # f32 FLOP/s without tensor cores, H100 SXM
HBM_BYTES_PER_S = 3.35e12


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _timed_ms(fn, iters: int) -> float:
    """Mean device time of one call: CUDA events around ``iters`` calls
    after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def _bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / F32_PEAK, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"[device] nvidia-smi: {smi}")
    print(f"[device] torch: {name} x{count}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    return smi, name, count


def phase_build():
    from paddle_tpu_torch.kernels import _build

    info = _build.build()
    _build.library()
    print(f"[build] {info.path.name}: {info.seconds:.2f} s "
          f"({'reused' if info.cached else 'built'})")
    for line in info.ptxas_lines():
        print(f"[build] {line}")
    return info.seconds


def _flash_cases(dev):
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    for tq, tk, causal in [(32, 32, True), (128, 128, True),
                           (512, 512, True), (128, 128, False),
                           (64, 256, True)]:
        q = torch.randn(4, tq, 12, 64, device=dev, generator=gen)
        k = torch.randn(4, tk, 12, 64, device=dev, generator=gen)
        v = torch.randn(4, tk, 12, 64, device=dev, generator=gen)
        yield tq, tk, causal, q, k, v


def phase_flash(dev, tol=1e-4):
    import torch
    import torch.nn.functional as tF

    from paddle_tpu_torch.kernels import flash_attention as fa

    rows = []
    for tq, tk, causal, q, k, v in _flash_cases(dev):
        out, lse = fa.flash_attention_bthd(q, k, v, causal=causal,
                                           return_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                                return_lse=True)
        err = max(float((out - ref).abs().max()),
                  float((lse - ref_lse).abs().max()))
        if not err <= tol:
            _fail(f"flash kernel T={tq}/{tk} causal={causal}: max abs err "
                  f"{err} > {tol}")
        ms = _timed_ms(lambda: fa.flash_attention_bthd(q, k, v, causal),
                       100)
        plain_ms = _timed_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                              causal), 20)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        mask = None
        if causal and tq != tk:   # SDPA's is_causal aligns top-left
            mask = torch.ones(tq, tk, dtype=torch.bool, device=dev).tril(
                tk - tq)
        lib_ms = _timed_ms(lambda: tF.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask,
            is_causal=causal and mask is None), 100)
        bound_ms, bound_by = _bound(*fa.flash_cost(4, tq, tk, 12, 64, causal))
        rows.append(dict(B=4, Tq=tq, Tk=tk, H=12, D=64, causal=causal,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms,
                         bound_by=bound_by))
        print(f"[flash] B=4 Tq={tq} Tk={tk} H=12 D=64 causal={causal}: "
              f"max_abs_err={err:.3e} (tol {tol}) kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by})")
    return rows


def _paged_inputs(dev, W, quant, n_sets):
    """Decode-step shapes: 8 slots + the scratch lane, 12 heads, head
    size 64, 16-position pages, 40-entry tables (max_len 640).  Rows sit
    at a page start, on and next to a boundary, mid-page, and one is
    parked with an all-sentinel table.  ``n_sets`` pool pairs (like the
    12 layers of a step) keep the timed reads out of the 50 MB L2."""
    import numpy as np
    import torch

    rs = np.random.RandomState(W + 2 * quant)
    B, H, D, P, n_pt = 9, 12, 64, 16, 40
    NP = 8 * n_pt
    lengths = np.array([0, 15, 16, 37, 100, 255, 333, 600, n_pt * P],
                       np.int32)
    pt = np.full((B, n_pt), NP, np.int32)
    perm = rs.permutation(NP)
    used = 0
    for b, ln in enumerate(lengths[:-1]):
        need = -(-int(ln + W) // P)
        pt[b, :need] = perm[used:used + need]
        used += need
    gen = torch.Generator(device=dev).manual_seed(W)
    q = torch.randn(B, W, H, D, device=dev, generator=gen)
    sets = []
    for _ in range(n_sets):
        if quant:
            kp, vp = (torch.randint(-127, 128, (NP, P, H, D), device=dev,
                                    generator=gen).to(torch.int8)
                      for _ in range(2))
            ks = (torch.rand(NP, P, device=dev, generator=gen) + 0.1) / 127
            vs = (torch.rand(NP, P, device=dev, generator=gen) + 0.1) / 127
        else:
            kp = torch.randn(NP, P, H, D, device=dev, generator=gen)
            vp = torch.randn(NP, P, H, D, device=dev, generator=gen)
            ks = vs = None
        sets.append((kp, vp, ks, vs))
    return (q, torch.from_numpy(pt).to(dev),
            torch.from_numpy(lengths).to(dev), lengths, sets)


def phase_paged(dev, tol=1e-4):
    import torch

    from paddle_tpu_torch.kernels import paged_attention as pa

    rows = []
    for quant in (False, True):
        for W in (1, 4):
            q, pt, lens, lens_np, sets = _paged_inputs(dev, W, quant, 8)
            live = lens < pt.shape[1] * 16
            err = 0.0
            for kp, vp, ks, vs in sets[:2]:
                out = pa.paged_decode_attention(q, kp, vp, pt, lens, ks, vs)
                torch.cuda.synchronize()
                ref = pa.paged_decode_attention_plain(q, kp, vp, pt, lens,
                                                      ks, vs)
                err = max(err, float((out[live] - ref[live]).abs().max()))
            if not err <= tol:
                _fail(f"paged kernel W={W} quant={quant}: max abs err "
                      f"{err} > {tol}")
            it = [0]

            def run(fn):
                kp, vp, ks, vs = sets[it[0] % len(sets)]
                it[0] += 1
                return fn(q, kp, vp, pt, lens, ks, vs)

            ms = _timed_ms(lambda: run(pa.paged_decode_attention), 96)
            plain_ms = _timed_ms(lambda: run(pa.paged_decode_attention_plain),
                                 16)
            bound_ms, bound_by = _bound(*pa.paged_cost(
                lens_np, W, 12, 64, 16, 40, quant))
            rows.append(dict(B=9, W=W, H=12, D=64, P=16, n_pt=40,
                             pool="int8" if quant else "f32",
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=None, bound_ms=bound_ms,
                             bound_by=bound_by))
            print(f"[paged] B=9 W={W} H=12 D=64 P=16 n_pt=40 "
                  f"{'int8' if quant else 'f32'}: max_abs_err={err:.3e} "
                  f"(tol {tol}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
                  f" bound {bound_ms:.4f} ms ({bound_by})")
            del sets
            torch.cuda.empty_cache()
    return rows


def _random_state(model, seed):
    """A JAX-layout numpy state for ``model`` from numpy's generator:
    N(0, 0.02) weights and embeddings, zero biases, unit LayerNorms."""
    import numpy as np

    from paddle_tpu_torch.models import to_jax_state

    rng = np.random.default_rng(seed)
    state = {}
    for name, arr in to_jax_state(model).items():
        if name.endswith("qkv_layout"):
            state[name] = arr
        elif name.endswith("bias"):
            state[name] = np.zeros(arr.shape, np.float32)
        elif ".norm" in name or "final_norm" in name:
            state[name] = np.ones(arr.shape, np.float32)
        else:
            state[name] = (rng.standard_normal(arr.shape, dtype=np.float32)
                           * np.float32(0.02))
    return state


def _serve(engine, prompts, new, rate_rs):
    """Submit from a background thread with exponential gaps (50/s, as
    the JAX bench's serving leg); wait for every result."""
    handles = []

    def feed():
        for p in prompts:
            handles.append(engine.submit(p, max_new_tokens=new))
            time.sleep(min(rate_rs.exponential(1.0 / 50.0), 0.25))

    t0 = time.perf_counter()
    th = threading.Thread(target=feed, name="chip-smoke-feeder")
    th.start()
    th.join(timeout=600)
    if th.is_alive() or len(handles) != len(prompts):
        _fail("the submitting thread did not finish")
    outs = [h.result(timeout=600) for h in handles]
    return handles, outs, time.perf_counter() - t0


def _teacher_forced(cpu_model, prompts, outs, margin):
    """Worst (max logit - served token's logit) over every served token,
    from the plain no-cache CPU forward over prompt + generated[:-1]."""
    import numpy as np
    import torch

    worst = 0.0
    with torch.no_grad():
        for p, g in zip(prompts, outs):
            seq = np.concatenate([p, g[:-1]]).astype(np.int64)
            lg = cpu_model(torch.from_numpy(seq[None]))[0]
            rows = lg[len(p) - 1:]
            gap = rows.max(dim=-1).values - rows[
                torch.arange(len(g)), torch.from_numpy(g)]
            if not bool(torch.isfinite(lg).all()):
                _fail("non-finite logits in the CPU reference")
            worst = max(worst, float(gap.max()))
    if not worst <= margin:
        _fail(f"teacher forcing: a served token is {worst} below the CPU "
              f"maximum (margin {margin})")
    return worst


def _profile(engine, prompts, new, trace_path):
    """``torch.profiler`` over a short serving window: device time by
    kernel name and the device's busy share of the window's wall time
    (the merged intervals of the device's kernels and copies are its busy
    time).  The chrome trace goes to ``trace_path`` when one is given."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    steps0 = engine.stats()["decode_steps"]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for h in [engine.submit(p, max_new_tokens=new) for p in prompts]:
            h.result(timeout=600)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    if trace_path:
        prof.export_chrome_trace(trace_path)
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            a, b = e.time_range.start, e.time_range.end
            spans.append((a, b))
            by_name[e.name] = by_name.get(e.name, 0.0) + (b - a)
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    res = dict(window_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
               decode_steps=engine.stats()["decode_steps"] - steps0,
               device_busy_share=busy / wall_us if spans else None,
               kernels_ms={k[:80]: v / 1e3 for k, v in top})
    if not spans:
        print("[profile] torch.profiler saw no device activity: device "
              "busy share not measured")
        return res
    print(f"[profile] {len(prompts)} requests x {new} tokens, "
          f"{res['decode_steps']} decode steps: window "
          f"{res['window_ms']:.2f} ms, device busy {res['device_busy_ms']:.2f}"
          f" ms ({100 * res['device_busy_share']:.1f}% of the window)")
    for k, v in res["kernels_ms"].items():
        print(f"[profile]   {v:10.3f} ms  {k}")
    return res


def phase_serve(dev, kv_dtype, n_req, new, seed, margin, profile=False,
                trace_path=None):
    import numpy as np
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.models import build_gpt, load_jax_state
    from paddle_tpu_torch.serving import Engine

    tag = f"serve{'-int8' if kv_dtype else ''}"
    t_build = time.perf_counter()
    model = build_gpt("gpt2-small-en", device=dev)
    cfg = model.config
    if (cfg.hidden_size, cfg.num_layers, cfg.num_attention_heads,
            cfg.vocab_size) != (768, N_LAYERS, 12, 50304):
        _fail(f"gpt2-small-en is not at full width: {cfg}")
    state = _random_state(model, seed)
    load_jax_state(model, state)
    cpu_model = build_gpt("gpt2-small-en", device="cpu")
    load_jax_state(cpu_model, state)
    t_build = time.perf_counter() - t_build
    rs = np.random.RandomState(seed)
    prompts = [rs.randint(0, cfg.vocab_size, rs.randint(32, 129))
               .astype(np.int64) for _ in range(n_req - 1)]
    prompts.insert(n_req // 2, rs.randint(0, cfg.vocab_size, 512)
                   .astype(np.int64))
    engine = Engine(model, max_slots=8, max_len=640, paged_kv=True,
                    page_size=16, max_queue=2 * n_req, kv_dtype=kv_dtype,
                    device=dev)
    try:
        # warm-up outside the counted run: cuBLAS handles, allocator
        engine.submit(prompts[0][:40], max_new_tokens=4).result(timeout=600)
        base = engine.stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.flash_attention_bthd.launches = 0
        pa.paged_decode_attention.launches = 0
        handles, outs, wall = _serve(engine, prompts, new, rs)
        flash_n = fa.flash_attention_bthd.launches
        paged_n = pa.paged_decode_attention.launches
        peak = torch.cuda.max_memory_allocated()
        st = engine.stats()
        prof = (_profile(engine, prompts[:8], new, trace_path)
                if profile else None)
    finally:
        engine.shutdown()
    prefills = st["prefill_batches"] - base["prefill_batches"]
    steps = st["decode_steps"] - base["decode_steps"]
    prefill_ms = 1e3 * (st["prefill_seconds"] - base["prefill_seconds"])
    decode_ms = 1e3 * (st["decode_seconds"] - base["decode_seconds"])
    done = st["completed"] - base["completed"]
    if done != n_req or any(len(o) != new for o in outs):
        _fail(f"{tag}: {done}/{n_req} requests completed: {st}")
    if st["slot_reuses"] <= 0:
        _fail(f"{tag}: no slot reuse: {st}")
    if flash_n != prefills * N_LAYERS or flash_n == 0:
        _fail(f"{tag}: flash launches {flash_n} != prefill batches "
              f"{prefills} x {N_LAYERS}")
    if paged_n != steps * N_LAYERS or paged_n == 0:
        _fail(f"{tag}: paged launches {paged_n} != decode steps {steps} x "
              f"{N_LAYERS}")
    worst = _teacher_forced(cpu_model, prompts, outs, margin)
    ttft = sorted(h.ttft_s for h in handles)
    res = dict(kv_dtype=kv_dtype or "f32", requests=n_req, new_tokens=new,
               wall_s=wall, tokens_per_s=n_req * new / wall,
               p50_ttft_ms=1e3 * ttft[len(ttft) // 2],
               peak_memory_bytes=peak, prefill_batches=prefills,
               decode_steps=steps, flash_launches=flash_n,
               paged_launches=paged_n, slot_reuses=st["slot_reuses"],
               prefill_batch_ms=prefill_ms / max(prefills, 1),
               decode_step_ms=decode_ms / max(steps, 1),
               teacher_forced_worst_gap=worst, margin=margin,
               model_build_s=t_build, profile=prof)
    print(f"[{tag}] {n_req} requests x {new} tokens in {wall:.3f} s: "
          f"{res['tokens_per_s']:.1f} tokens/s, p50 TTFT "
          f"{res['p50_ttft_ms']:.2f} ms, peak memory {peak / 2**20:.1f} "
          f"MiB; {prefills} prefill batches ({flash_n} flash launches), "
          f"{steps} decode steps ({paged_n} paged launches); teacher-forced"
          f" worst gap {worst:.3e} (margin {margin}); host wall per "
          f"prefill batch {res['prefill_batch_ms']:.3f} ms, per decode "
          f"step {res['decode_step_ms']:.3f} ms")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the measurements as JSON")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "paddle_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (no "
              "paddle_tpu_torch/ beside this script)", file=sys.stderr)
        return 1
    sys.path.insert(0, here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    smi, name, count = phase_device()
    build_s = phase_build()
    flash = phase_flash(dev)
    paged = phase_paged(dev)
    trace = None
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        trace = os.path.splitext(os.path.abspath(args.out))[0] + ".trace.json"
    serve = phase_serve(dev, None, 24, 32, args.seed, 1e-3, profile=True,
                        trace_path=trace)
    serve8 = phase_serve(dev, "int8", 8, 16, args.seed + 1, 2e-2)
    for res in (serve, serve8):
        print(f"[metrics] {res['kv_dtype']}: {res['tokens_per_s']:.1f} "
              f"tokens/s, p50 TTFT {res['p50_ttft_ms']:.2f} ms, peak "
              f"memory {res['peak_memory_bytes']} bytes on {smi}")
    f_main = next(r for r in flash if r["Tq"] == 128 and r["causal"])
    p_main = next(r for r in paged if r["W"] == 1 and r["pool"] == "f32")
    kernels = [
        dict(name="flash_attention_fwd", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/flash_attention_fwd.cu",
             replaces="paddle_tpu/kernels/flash_attention.py:208",
             launches=serve["flash_launches"],
             max_abs_err=max(r["max_abs_err"] for r in flash),
             ms=f_main["ms"], plain_ms=f_main["plain_ms"],
             bound_ms=f_main["bound_ms"], bound_by=f_main["bound_by"],
             library_ms=f_main["library_ms"],
             shape="B=4 T=128 H=12 D=64 causal"),
        dict(name="paged_decode_attention", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/paged_attention.cu",
             replaces="paddle_tpu/kernels/paged_attention.py:281",
             launches=serve["paged_launches"],
             max_abs_err=max(r["max_abs_err"] for r in paged),
             ms=p_main["ms"], plain_ms=p_main["plain_ms"],
             bound_ms=p_main["bound_ms"], bound_by=p_main["bound_by"],
             library_ms=None, shape="B=9 W=1 H=12 D=64 P=16 n_pt=40 f32"),
    ]
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(dict(device=smi, torch_device=name, count=count,
                           build_s=build_s, flash=flash, paged=paged,
                           serve=[serve, serve8], kernels=kernels,
                           total_s=time.perf_counter() - t_all), fh,
                      indent=1)
    print(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
