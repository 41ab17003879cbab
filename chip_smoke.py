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
8. tokens/s, p50 time to first token and peak device memory;
9. the flash backward kernels (dk/dv and dq) against
   ``flash_attention_bwd_plain`` in f32 and bf16, on the fused operand and
   on separate q, k, v, causal and full, at B=4 T=128, B=4 T=1024, B=2
   T=1100 (ragged) and Tq=64 Tk=256 (separate only), H=12 D=64; then the
   fused forward and backward at the training shape (B=16 T=1024 bf16).
   Each case times kernel, plain version, PyTorch's
   ``scaled_dot_product_attention`` (forward+backward under autograd: the
   yardstick the port never calls) and the bound, against the bf16 peak
   (989 TFLOP/s dense, H100 SXM data sheet) for bf16 operands;
10. attention training through ``F.scaled_dot_product_attention``
   (separate q, k, v) at B=4 T=1024 and B=2 T=1100, bf16: one forward and
   one launch of each backward kernel per call;
11. train: ``gpt2-small-en`` at full width, batch 16 x 1024,
   ``compute_dtype=torch.bfloat16`` over f32 masters, AdamW lr 1e-4 and
   weight decay 0.01, dropout 0, random weights from a numpy seed: one
   warm-up and 5 timed steps on one batch; exactly 12 launches a step of
   the fused forward and of each backward kernel, none of the
   separate-operand wrappers or of a plain version; the loss must be
   finite and fall; then one profiled step;
12. parity: gpt2-small-en width with 2 layers, batch 2 x 1024, f32, three
   steps on the card against the same three steps on the CPU (plain
   versions) from the same weights: losses within 1e-4 relative.

Prints ``{"kernels": [...]}`` and the ``nvidia-smi`` line before the last
line, which is ``{"ok": true, "device": {...}}``.  ``--out PATH`` also
writes every measured number as JSON, and the profiled serving window's
chrome trace beside it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import threading
import time

N_LAYERS = 12
F32_PEAK = 67e12          # f32 FLOP/s without tensor cores, H100 SXM
BF16_PEAK = 989e12        # dense bf16 tensor-core FLOP/s, H100 SXM
HBM_BYTES_PER_S = 3.35e12


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _timed_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of one call: CUDA events around ``iters`` calls
    after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
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


def _bound(flops: float, nbytes: float, peak: float = F32_PEAK):
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
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


def _device_profile(fn, trace_path=None, top=10):
    """``torch.profiler`` around ``fn()``: the window's wall time, the
    device's busy time in it (the merged intervals of the device's kernels
    and copies) and device time by kernel name, all in ms; ``busy_share``
    is None when the profiler saw no device activity.  The chrome trace
    goes to ``trace_path`` when one is given."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
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
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return dict(window_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
                device_busy_share=busy / wall_us if spans else None,
                kernels_ms={k[:80]: v / 1e3 for k, v in ranked[:top]},
                all_kernels_ms={k: v / 1e3 for k, v in ranked})


def _print_profile(tag, what, res):
    if res["device_busy_share"] is None:
        print(f"[{tag}] torch.profiler saw no device activity: device busy "
              f"share not measured")
        return
    print(f"[{tag}] {what}: window {res['window_ms']:.2f} ms, device busy "
          f"{res['device_busy_ms']:.2f} ms "
          f"({100 * res['device_busy_share']:.1f}% of the window)")
    for k, v in res["kernels_ms"].items():
        print(f"[{tag}]   {v:10.3f} ms  {k}")


def _profile(engine, prompts, new, trace_path):
    """A short serving window under :func:`_device_profile`."""
    steps0 = engine.stats()["decode_steps"]

    def window():
        for h in [engine.submit(p, max_new_tokens=new) for p in prompts]:
            h.result(timeout=600)

    res = _device_profile(window, trace_path)
    res.pop("all_kernels_ms")
    res["decode_steps"] = engine.stats()["decode_steps"] - steps0
    _print_profile("profile", f"{len(prompts)} requests x {new} tokens, "
                   f"{res['decode_steps']} decode steps", res)
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


_PLAIN = ("flash_attention_plain", "flash_attention_bwd_plain",
          "flash_attention_qkv_fused_plain",
          "flash_attention_qkv_fused_bwd_plain")


@contextlib.contextmanager
def _no_plain():
    """Any call of a flash plain version inside raises: the path under
    test must launch the kernels."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    saved = {n: getattr(fa, n) for n in _PLAIN}

    def tripwire(name):
        def call(*args, **kwargs):
            raise RuntimeError(f"{name} ran on a path that must launch the "
                               f"CUDA kernels")
        return call

    for n in _PLAIN:
        setattr(fa, n, tripwire(n))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(fa, n, fn)


def _attention_counters(zero=False):
    """The flash launch counters (set to 0 first with ``zero``)."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    slots = [(fa.flash_attention_bthd, "launches", "fwd"),
             (fa.flash_attention_qkv_fused, "launches", "fused_fwd"),
             (fa.flash_attention_bwd, "launches_dkv", "bwd_dkv"),
             (fa.flash_attention_bwd, "launches_dq", "bwd_dq"),
             (fa.flash_attention_qkv_fused_bwd, "launches_dkv",
              "fused_bwd_dkv"),
             (fa.flash_attention_qkv_fused_bwd, "launches_dq",
              "fused_bwd_dq")]
    if zero:
        for fn, attr, _ in slots:
            setattr(fn, attr, 0)
    return {key: getattr(fn, attr) for fn, attr, key in slots}


def _max_err(got, want, dtype, what):
    """Largest |got - want| over the tensors; fails past the dtype's
    tolerance (f32: 1e-4 + 1e-4|want|; bf16: 1e-2 + 1e-2|want|, about one
    bf16 rounding of the result)."""
    import torch

    tol = 1e-4 if dtype == torch.float32 else 1e-2
    err = 0.0
    for g, w in zip(got, want):
        d = (g.float() - w.float()).abs()
        if not bool((d <= tol + tol * w.float().abs()).all()):
            _fail(f"{what}: max abs err {float(d.max())} past {tol} + "
                  f"{tol}|ref|")
        err = max(err, float(d.max()))
    return err


def _split_ms(fn, calls=3):
    """Device ms per call of each flash backward kernel in ``fn``, from
    ``torch.profiler``."""
    res = _device_profile(lambda: [fn() for _ in range(calls)])
    out = {"dkv": 0.0, "dq": 0.0}
    for name, ms in res["all_kernels_ms"].items():
        for part in out:
            if f"flash_bwd_{part}_kernel" in name:
                out[part] += ms / calls
    return out


def _bwd_case(dev, gen, dtype, B, tq, tk, fused, causal, H=12, D=64,
              iters=10, plain_iters=3, split=False):
    import torch
    import torch.nn.functional as tF

    from paddle_tpu_torch.kernels import flash_attention as fa

    scale = 1.0 / D ** 0.5
    if fused:
        qkv = torch.randn(B, tq, H, 3, D, device=dev, generator=gen).to(dtype)
        q, k, v = qkv.unbind(3)
        out, lse = fa._fused_fwd(qkv, causal, scale)
        do = torch.randn(B, tq, H * D, device=dev, generator=gen).to(dtype)

        def kern():
            return fa.flash_attention_qkv_fused_bwd(qkv, out, lse, do, causal)

        def plain():
            return fa.flash_attention_qkv_fused_bwd_plain(qkv, out, lse, do,
                                                          causal)
    else:
        q, k, v = (torch.randn(B, t, H, D, device=dev, generator=gen)
                   .to(dtype) for t in (tq, tk, tk))
        out, lse = fa.flash_attention_bthd(q, k, v, causal, return_lse=True)
        do = torch.randn(B, tq, H, D, device=dev, generator=gen).to(dtype)

        def kern():
            return fa.flash_attention_bwd(q, k, v, out, lse, do, causal)

        def plain():
            return fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
    got = kern()
    torch.cuda.synchronize()
    want = plain()
    if fused:
        got, want = got.unbind(3), want.unbind(3)
    name = (f"B={B} Tq={tq} Tk={tk} H={H} D={D} "
            f"{'bf16' if dtype == torch.bfloat16 else 'f32'} "
            f"{'fused' if fused else 'separate'} "
            f"{'causal' if causal else 'full'}")
    err = _max_err(got, want, dtype, f"flash backward {name}")
    del got, want
    ms = _timed_ms(kern, iters)
    plain_ms = _timed_ms(plain, plain_iters, warmup=0)
    qh, kh, vh = (x.detach().transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    doh = do.reshape(B, tq, H, D).transpose(1, 2).contiguous()
    mask = None
    if causal and tq != tk:   # SDPA's is_causal aligns top-left
        mask = torch.ones(tq, tk, dtype=torch.bool, device=dev).tril(tk - tq)

    def library():
        o = tF.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, is_causal=causal and mask is None)
        return torch.autograd.grad(o, (qh, kh, vh), doh)

    lib_ms = _timed_ms(library, iters)
    item = 2 if dtype == torch.bfloat16 else 4
    peak = BF16_PEAK if dtype == torch.bfloat16 else F32_PEAK
    bound_ms, bound_by = _bound(
        *fa.flash_bwd_cost(B, tq, tk, H, D, causal, itemsize=item), peak)
    row = dict(B=B, Tq=tq, Tk=tk, H=H, D=D, dtype=str(dtype).split(".")[1],
               fused=fused, causal=causal, max_abs_err=err, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
               bound_by=bound_by)
    parts = ""
    if split:
        row["kernel_ms"] = _split_ms(kern)
        for part in ("dq", "dkv"):
            row[f"bound_{part}"] = _bound(*fa.flash_bwd_cost(
                B, tq, tk, H, D, causal, itemsize=item, part=part), peak)
        parts = (f" (dk/dv {row['kernel_ms']['dkv']:.4f}, dq "
                 f"{row['kernel_ms']['dq']:.4f})")
    print(f"[flash-bwd] {name}: max_abs_err={err:.3e} kernel {ms:.4f} ms"
          f"{parts}, plain {plain_ms:.4f} ms, sdpa fwd+bwd {lib_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by})")
    return row


def _fused_fwd_case(dev, gen, B=16, T=1024, H=12, D=64):
    """The fused forward at the training step's shape, bf16."""
    import torch
    import torch.nn.functional as tF

    from paddle_tpu_torch.kernels import flash_attention as fa

    qkv = torch.randn(B, T, H, 3, D, device=dev, generator=gen).to(
        torch.bfloat16)
    out, lse = fa._fused_fwd(qkv, True, 1.0 / D ** 0.5)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_qkv_fused_plain(qkv, True,
                                                      return_lse=True)
    err = max(_max_err([out], [ref], torch.bfloat16, "fused forward"),
              _max_err([lse], [ref_lse], torch.float32, "fused forward lse"))
    del ref, ref_lse
    ms = _timed_ms(lambda: fa.flash_attention_qkv_fused(qkv), 20)
    plain_ms = _timed_ms(lambda: fa.flash_attention_qkv_fused_plain(qkv),
                         2, warmup=0)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in qkv.unbind(3))
    lib_ms = _timed_ms(lambda: tF.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True), 20)
    bound_ms, bound_by = _bound(*fa.flash_cost(B, T, T, H, D, True,
                                               itemsize=2), BF16_PEAK)
    print(f"[flash-fused-fwd] B={B} T={T} H={H} D={D} bf16 causal: "
          f"max_abs_err={err:.3e} kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return dict(B=B, Tq=T, Tk=T, H=H, D=D, dtype="bfloat16", fused=True,
                causal=True, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)


def phase_flash_bwd(dev):
    import torch

    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for B, tq, tk in ((4, 128, 128), (4, 1024, 1024), (2, 1100, 1100),
                          (4, 64, 256)):
            for fused in (True, False):
                if fused and tq != tk:
                    continue
                for causal in (True, False):
                    split = (dtype == torch.bfloat16 and causal and
                             not fused and tq == tk and tq >= 1024)
                    rows.append(_bwd_case(dev, gen, dtype, B, tq, tk, fused,
                                          causal, split=split))
                    torch.cuda.empty_cache()
    fwd = _fused_fwd_case(dev, gen)
    # the training step's shape: the plain backward runs once, timed
    main = _bwd_case(dev, gen, torch.bfloat16, 16, 1024, 1024, True, True,
                     plain_iters=1, split=True)
    torch.cuda.empty_cache()
    return rows, fwd, main


def phase_attention_train(dev):
    """Attention training through the functional API on separate q, k, v
    (``F.scaled_dot_product_attention`` under autograd), bf16: per call one
    forward launch and one launch of each backward kernel."""
    import torch

    from paddle_tpu_torch.nn import functional as F

    gen = torch.Generator(device=dev).manual_seed(2)
    res = {}
    for B, T in ((4, 1024), (2, 1100)):
        q, k, v = (torch.randn(B, T, 12, 64, device=dev, generator=gen)
                   .to(torch.bfloat16).requires_grad_() for _ in range(3))
        do = torch.randn(B, T, 12, 64, device=dev, generator=gen).to(
            torch.bfloat16)
        _attention_counters(zero=True)
        with _no_plain():
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                 training=True)
            out.backward(do)
            torch.cuda.synchronize()
        n = _attention_counters()
        want = dict(fwd=1, fused_fwd=0, bwd_dkv=1, bwd_dq=1, fused_bwd_dkv=0,
                    fused_bwd_dq=0)
        if n != want:
            _fail(f"attention training B={B} T={T}: launches {n} != {want}")
        if not all(bool(torch.isfinite(x.grad).all()) for x in (q, k, v)):
            _fail(f"attention training B={B} T={T}: non-finite gradients")
        res[T] = n
        print(f"[attention-train] B={B} T={T} H=12 D=64 bf16 causal: "
              f"launches {n}")
    return res


def _train_model(dev, seed, **overrides):
    from paddle_tpu_torch.models import build_gpt, load_jax_state

    model = build_gpt("gpt2-small-en", device=dev, hidden_dropout_prob=0.0,
                      attention_dropout_prob=0.0, **overrides)
    load_jax_state(model, _random_state(model, seed))
    return model


def _train_step(model, compute_dtype=None):
    from paddle_tpu_torch.distributed import make_train_step
    from paddle_tpu_torch.models import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    opt = AdamW(learning_rate=1e-4, parameters=model, weight_decay=0.01)
    return make_train_step(model, opt, loss_fn=GPTPretrainingCriterion(),
                           compute_dtype=compute_dtype)


def phase_train(dev, seed, smi, steps=5, batch=16, seq=1024):
    import numpy as np
    import torch

    from paddle_tpu_torch.models import gpt_train_flops_per_token

    model = _train_model(dev, seed)
    cfg = model.config
    if (cfg.hidden_size, cfg.num_layers, cfg.num_attention_heads,
            cfg.vocab_size) != (768, N_LAYERS, 12, 50304):
        _fail(f"gpt2-small-en is not at full width: {cfg}")
    step = _train_step(model, torch.bfloat16)
    ids = np.random.RandomState(seed).randint(
        0, cfg.vocab_size, size=(batch, seq + 1)).astype(np.int64)
    x = torch.from_numpy(ids[:, :-1]).to(dev)
    y = torch.from_numpy(ids[:, 1:]).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _attention_counters(zero=True)
    with _no_plain():
        losses = [float(step(x, y))]               # warm-up
        t0 = time.perf_counter()
        outs = [step(x, y) for _ in range(steps)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = _attention_counters()
    peak = torch.cuda.max_memory_allocated()
    losses += [float(v) for v in outs]
    want = dict(fwd=0, fused_fwd=N_LAYERS * (steps + 1), bwd_dkv=0, bwd_dq=0,
                fused_bwd_dkv=N_LAYERS * (steps + 1),
                fused_bwd_dq=N_LAYERS * (steps + 1))
    if n != want:
        _fail(f"train: launches {n} != {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        _fail(f"train: losses {losses} are not finite and falling")
    if step.compile_count != 1:
        _fail(f"train: {step.compile_count} step builds for one signature")
    tokens_per_s = steps * batch * seq / wall
    share = tokens_per_s * gpt_train_flops_per_token(cfg, seq) / BF16_PEAK
    prof = _device_profile(lambda: step(x, y))
    prof.pop("all_kernels_ms")
    res = dict(batch=batch, seq=seq, steps=steps, losses=losses,
               step_ms=1e3 * wall / steps, tokens_per_s=tokens_per_s,
               flops_share=share, peak_memory_bytes=peak, launches=n,
               launches_per_step={k: v // (steps + 1) for k, v in n.items()},
               profile=prof)
    print(f"[train] gpt2-small-en B={batch} T={seq} bf16 AdamW: losses "
          f"{', '.join(f'{v:.6f}' for v in losses)}")
    print(f"[train] {res['step_ms']:.3f} ms a step, {tokens_per_s:.1f} "
          f"tokens/s, flops share {100 * share:.2f}% of the 989 TFLOP/s "
          f"dense bf16 peak (H100 SXM data sheet), peak memory {peak} bytes"
          f", launches a step {res['launches_per_step']} on {smi}")
    _print_profile("train-profile", "one step", prof)
    return res


def phase_train_parity(dev, seed, tol=1e-4):
    """Three f32 steps of a 2-layer full-width model on the card and on
    the CPU from the same weights: the kernels against the plain
    versions through the whole step."""
    import numpy as np
    import torch

    ids = np.random.RandomState(seed + 1).randint(
        0, 50304, size=(2, 1025)).astype(np.int64)
    losses = {}
    t0 = time.perf_counter()
    for where in (dev, torch.device("cpu")):
        step = _train_step(_train_model(where, seed, num_layers=2))
        losses[where.type] = [float(step(ids[:, :-1], ids[:, 1:]))
                              for _ in range(3)]
    card, cpu = np.array(losses["cuda"]), np.array(losses["cpu"])
    rel = float(np.max(np.abs(card - cpu) / np.abs(cpu)))
    print(f"[parity] 2 layers, B=2 T=1024 f32: card {card.tolist()}, cpu "
          f"{cpu.tolist()}, max rel diff {rel:.3e} (tol {tol}), "
          f"{time.perf_counter() - t0:.1f} s")
    if not rel <= tol:
        _fail(f"parity: card and CPU losses differ by {rel} > {tol}")
    return dict(card=card.tolist(), cpu=cpu.tolist(), max_rel_diff=rel,
                tol=tol)


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
    # the new phases follow PR 1's: their profiler sessions (the backward's
    # per-kernel split) must not sit before the serving phases' host timing
    torch.cuda.empty_cache()
    bwd, fused_fwd, fused_bwd = phase_flash_bwd(dev)
    att = phase_attention_train(dev)
    train = phase_train(dev, args.seed, smi)
    torch.cuda.empty_cache()
    parity = phase_train_parity(dev, args.seed)
    f_main = next(r for r in flash if r["Tq"] == 128 and r["causal"])
    p_main = next(r for r in paged if r["W"] == 1 and r["pool"] == "f32")
    # kernel 2 (single tile, T <= 1024) and kernels 3, 4 (the split, T >
    # 1024): the separate-operand backward, bf16 causal, at the shapes of
    # the attention-training phase
    sep_1024, sep_1100 = (next(
        r for r in bwd if r["dtype"] == "bfloat16" and not r["fused"]
        and r["causal"] and r["Tq"] == t) for t in (1024, 1100))
    bwd_err = max(r["max_abs_err"] for r in bwd + [fused_bwd])
    bwd_src = "paddle_tpu_torch/kernels/csrc/flash_attention_bwd.cu"
    fa_py = "paddle_tpu/kernels/flash_attention.py"

    def bwd_row(name, line, launches, row, part=None):
        bound = ((row["bound_ms"], row["bound_by"]) if part is None
                 else row[f"bound_{part}"])
        return dict(name=name, route="cuda", source=bwd_src,
                    replaces=f"{fa_py}:{line}", launches=launches,
                    max_abs_err=bwd_err,
                    ms=row["ms"] if part is None else row["kernel_ms"][part],
                    plain_ms=row["plain_ms"], bound_ms=bound[0],
                    bound_by=bound[1], library_ms=row["library_ms"],
                    shape=f"B={row['B']} T={row['Tq']} H=12 D=64 "
                          f"{row['dtype']} causal"
                          f"{' fused' if row['fused'] else ''}")

    n_tr, n_att = train["launches"], att
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
        dict(name="flash_attention_qkv_fused", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/flash_attention_fwd.cu",
             replaces=f"{fa_py}:490", launches=n_tr["fused_fwd"],
             max_abs_err=fused_fwd["max_abs_err"], ms=fused_fwd["ms"],
             plain_ms=fused_fwd["plain_ms"], bound_ms=fused_fwd["bound_ms"],
             bound_by=fused_fwd["bound_by"],
             library_ms=fused_fwd["library_ms"],
             shape="B=16 T=1024 H=12 D=64 bfloat16 causal"),
        bwd_row("flash_attention_qkv_fused_bwd (dk/dv + dq kernels)", 534,
                n_tr["fused_bwd_dkv"] + n_tr["fused_bwd_dq"], fused_bwd),
        bwd_row("flash_attention_bwd (dk/dv + dq kernels)", 371,
                n_att[1024]["bwd_dkv"] + n_att[1024]["bwd_dq"], sep_1024),
        bwd_row("flash_bwd_dq_kernel", 402, n_att[1100]["bwd_dq"], sep_1100,
                "dq"),
        bwd_row("flash_bwd_dkv_kernel", 425, n_att[1100]["bwd_dkv"],
                sep_1100, "dkv"),
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
                           flash_bwd=bwd, fused_fwd=fused_fwd,
                           fused_bwd=fused_bwd, serve=[serve, serve8],
                           attention_train=att, train=train,
                           parity=parity, kernels=kernels,
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
