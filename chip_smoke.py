#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card and fails without one.  Phases, in order (any failure ends the
run with a non-zero exit, and nothing is caught):

1. the card: ``nvidia-smi`` name and power limit, device name and count;
2. build the CUDA kernels from ``paddle_tpu_torch/kernels/csrc`` with
   ``nvcc`` (seconds, plus the ``-Xptxas -v`` register/shared-memory
   report) and print, for each flash, ``ln_matmul``, conv+BN and paged
   kernel, the ``HGMMA`` (wgmma), ``UTMALDG`` (TMA load) and ``UBLKCP``
   (1-D bulk copy) instructions ``cuobjdump -sass`` finds in it; a gate
   for the conv+BN wgmma kernels, which must show HGMMA and UTMALDG, and
   for every paged chunk kernel, which must show an async copy (UTMALDG
   or UBLKCP; without cuobjdump the run fails);
3. hold each kernel against its plain PyTorch version at the serving
   path's shapes, TF32 off, and time kernel, plain version, the bound
   (the larger of flops over the operands' peak, 67 TFLOP/s f32 or 989
   bf16, and bytes / 3.35 TB/s, H100 SXM data sheet) and, for flash
   attention, PyTorch's ``scaled_dot_product_attention`` as a yardstick
   the port never calls; f32 at B=4 (held at 1e-4) and one bf16 case at
   the prefill shape B=4 T=512 causal (bf16 tolerance); device ms from
   CUDA-graph replays, the eager call's ms beside; the paged decode
   kernel at every case of ``PAGED_CASES`` (B=9 H=12 D=64 P=16: the
   decode step's rows at W=1 and 4 over f32 and int8 pools, a full pool
   of 8 rows at 560-639 tokens, and a 512-entry table at W=8), one launch
   a call, held at 1e-4, with the gather + ``scaled_dot_product_attention``
   yardstick beside (two calls: no one PyTorch call computes a paged
   read);
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
   Each case times kernel (delta, dk/dv and dq kernels), plain version,
   PyTorch's ``scaled_dot_product_attention`` (forward+backward under
   autograd, and its backward alone as that minus its forward: the
   yardsticks the port never calls) and the bound, against the bf16 peak
   (989 TFLOP/s dense, H100 SXM data sheet) for bf16 operands; device
   ms from CUDA-graph replays, the eager call's ms beside; then causal
   Tq > Tk at the reference's tile boundaries ((Tq, Tk) = (200, 120),
   (1100, 600), (2100, 1000), (3100, 1100); B=1 H=4 D=64, f32 and bf16):
   out, lse, dq, dk, dv against the plain versions, the rows with no live
   key included, one launch of the dead-row pass each way;
10. attention training through ``F.scaled_dot_product_attention``
   (separate q, k, v) at B=4 T=1024 and B=2 T=1100, bf16: one forward and
   one launch of each backward kernel per call;
11. train: ``gpt2-small-en`` at full width, batch 16 x 1024,
   ``compute_dtype=torch.bfloat16`` over f32 masters, AdamW lr 1e-4 and
   weight decay 0.01, dropout 0, random weights from a numpy seed: one
   warm-up and 5 timed steps on one batch; exactly 12 launches a step of
   the fused forward and of each backward kernel (delta, dk/dv, dq), none
   of the separate-operand wrappers or of a plain version; the loss must
   be finite and fall; then one profiled step (attention kernels' ms a
   step); then one step of the same weights and batch with the plain
   attention in place of the kernels (the plain versions allowed for
   that step alone, no flash launch): its loss within 1e-3 relative of
   the kernel step's first;
12. parity: gpt2-small-en width with 2 layers, batch 2 x 1024, f32, three
   steps on the card against the same three steps on the CPU (plain
   versions) from the same weights: losses within 1e-4 relative;
13. the LayerNorm kernels (forward, and the backward's dx kernel with its
   dw/db column sum) against their plain versions at N=16384 C=768 (one
   LayerNorm of the training step) in bf16 and f32, at N=1000 and N=8,
   at the widths past a lane's registers (N=4096: C=1280 and 4096 f32,
   2560 and 8192 bf16), and with the ``ln_matmul`` backward's f32 dy
   beside bf16 x (N=16384 C=768); each times kernel, plain version,
   ``torch.nn.functional.
   layer_norm`` (forward; forward+backward under autograd for the
   backward: the yardsticks the port never calls) and the bound (bytes),
   rotating over input sets that outgrow the 50 MB L2.  Device ms come
   from CUDA-graph replays of back-to-back calls; the ms of an eager call
   (CUDA events, host included) is printed beside them;
14. the ``ln_matmul`` kernels (bf16: the statistics pass and the wgmma
   product) against their plain version at N=16384 K=768 M=2304 (qkv) and
   3072 (fc0), N=4096 K=1280 M=3840 and N=2048 K=1024 M=4096 in bf16,
   N=300 in f32 and N=8 in bf16; times kernel (and TFLOP/s), plain
   version, ``layer_norm`` + ``torch.matmul`` and the bound (operations,
   at the bf16 peak for bf16), as phase 13, and prints the bf16 kernel's
   ``HGMMA`` and ``UTMALDG`` counts from phase 2;
15. fused-LayerNorm training: phase 11's step from the same weights and
   batch with ``enable_ln_matmul(True)`` and ``enable_fused_layernorm(
   "full")``: one warm-up and 5 timed steps, exactly 24 ``ln_matmul``
   launches and 25 LayerNorm forwards and backwards (dx kernel and column
   sum) a step -- each ``ln_matmul`` backward runs one of each, the final
   norm the 25th -- besides phase 11's attention launches, no plain
   version; losses finite, falling and within 1e-3 relative of phase
   11's; then LayerNorm "full" alone (25 + 25 a step) and "bwd" alone
   (0 + 25), one warm-up and two timed steps each; then one profiled
   both-on step (the ``ln_matmul`` and LayerNorm kernels' ms, and the
   step's kernels by device time);
16. fused-LayerNorm parity: phase 12 with both toggles on (4 ``ln_matmul``
   launches and 5 LayerNorm forwards and backwards a step on the card),
   losses within 1e-4 relative of the CPU's;
17. fused-LayerNorm serving: 8 f32 requests with
   ``enable_fused_layernorm("full")``: 25 LayerNorm forward launches a
   prefill batch and a decode step, phase 4's flash and paged counts, and
   the teacher-forced check (margin 1e-3) against the default CPU
   forward, with the toggle off again before it runs;
18. the conv+BN kernels (rows 11-13: ``csrc/conv_bn.cu``) against their
   plain versions at every shape of the experiment scripts: the 8 1x1
   shapes of ``tools/exp_conv_bn.py`` (``fused_conv1x1_bn``), the 3 of
   ``tools/exp_conv_bn2.py`` in its four variants (``run_mm`` with
   ``_k_mm`` and ``_k_stat``, ``run_pro``, ``fused_conv1x1_bn``), a
   ragged M, the 4 3x3 shapes of ``tools/exp_conv3x3.py`` (``fused3x3``)
   and a 3x3 with b > 0 at the border; y at the bf16 tolerance, each row
   of the statistics at the column-sum tolerance of its own size and
   nearer the sums of the f32 accumulator than those of the rounded y;
   device ms of kernel, plain version, the fused library yardstick
   (TorchInductor's prologue and column sums around cuBLAS ``matmul`` or
   cuDNN ``conv2d``) and the scripts' ``xla_chain`` run eagerly
   (``chain_1x1``/``chain_3x3``; ``torch.matmul`` for the bare product)
   from CUDA-graph replays over input sets that outgrow the L2, and the
   bound at the bf16 peak; each case's route (``wgmma`` or the kept
   ``mma.sync``, from the route counters of its checked call) and tile
   beside its ms: every script shape must take ``wgmma``;
   ``cudnn.benchmark`` on;
19. ResNet-50 training at the bench's size (``bench.py:386-473``):
   ``resnet50(num_classes=1000)`` with random weights from a numpy seed
   through ``load_jax_state``, batch 128 x 3 x 224^2 f32 and int64 labels
   from ``RandomState(seed)``, ``Momentum(0.1, 0.9, weight_decay=1e-4)``,
   ``CrossEntropyLoss``, ``compute_dtype=torch.bfloat16``, channels_last,
   ``cudnn.benchmark`` on (TF32 off): one warm-up step, then 10 steps
   through ``run_steps``; the loss finite and falling, one step build,
   the running statistics moved, no conv+BN kernel and no plain version
   on the path; step ms, images/s, flops share (the model's own conv and
   fc shapes, 2 FLOPs a multiply-add, x3) and peak memory; then one
   profiled step;
20. ResNet parity: ``ResNet(depth=50)`` at batch 4 x 64^2, f32, three
   steps on the card against the CPU from the same weights: losses within
   1e-4 relative, running statistics within 1e-3;
21. (run between 18 and 19, on phase 19's model and batch before it
   trains) the conv+BN kernels on the model's own activations: one bf16
   forward of phase 19's batch, hooks on the stride-1 bottlenecks
   ``layer1[1]`` and ``layer3[1]``; kernel 12 from conv1's raw output and
   bn1's batch scale and shift against conv2's output and bn2's
   statistics, kernels 11 and ``run_pro`` from conv2's against conv3's
   and bn3's, ``run_mm`` on the model's conv3 input (bf16 tolerance);
   with the launch counters set to 0 just before and read just after
   (these are the ``launches`` of rows 11-13, each ``run_mm`` body on its
   own counter; every launch on the wgmma route's counters, and one
   prologue pass for each call whose plan takes one).

Every toggle a phase turns on is turned off in a ``finally`` that lets the
error through.

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


def _kernel_name(mangled):
    """``flash_fwd_bf16_kernel<64>`` from a mangled kernel symbol."""
    import re

    m = re.search(r"\d+((?:flash|ln|conv|paged)_\w+?_kernel)I(.+?)EEv",
                  mangled)
    if not m:
        m = re.search(r"\d+((?:flash|ln|conv|paged)_\w+?_kernel)", mangled)
        return m.group(1) if m else mangled
    args = m.group(2).replace("13__nv_bfloat16", "bf16,")
    args = re.sub(r"L[ib](\d+)E", r"\1,", args)
    args = "float," + args[1:] if args.startswith("f") else args
    args = "int8," + args[1:] if args.startswith("a") else args
    return f"{m.group(1)}<{args.strip(',')}>"


def _sass_counts(lib_path):
    """``HGMMA`` (wgmma), ``UTMALDG`` (TMA load) and ``UBLKCP`` (1-D bulk
    copy) instructions in each flash, ``ln_matmul``, conv+BN and paged
    kernel's SASS (``cuobjdump -sass``), as ``{kernel: (hgmma, utmaldg,
    ublkcp)}``, or None where the toolkit has no cuobjdump."""
    import re
    import shutil

    cob = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(cob):
        return None
    sass = subprocess.run([cob, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            fn = (_kernel_name(name) if "flash_" in name
                  or "ln_matmul_" in name or "conv_wgmma_" in name
                  or "conv3x3_mma_" in name or "paged_" in name else None)
            if fn:
                counts[fn] = [0, 0, 0]
        elif fn and "HGMMA" in line:
            counts[fn][0] += 1
        elif fn and "UTMALDG" in line:
            counts[fn][1] += 1
        elif fn and "UBLKCP" in line:
            counts[fn][2] += 1
    return {k: tuple(v) for k, v in counts.items()}


def phase_build():
    from paddle_tpu_torch.kernels import _build

    info = _build.build()
    _build.library()
    print(f"[build] {info.path.name}: {info.seconds:.2f} s "
          f"({'reused' if info.cached else 'built'})")
    for line in info.ptxas_lines():
        print(f"[build] {line}")
    sass = _sass_counts(info.path)
    if sass is None:
        print("[build] HGMMA / UTMALDG: cuobjdump not found")
    for name, (n, t, u) in sorted((sass or {}).items()):
        print(f"[build] HGMMA {n:3d}, UTMALDG {t:3d}, UBLKCP {u:3d} in "
              f"{name}")
        if name.startswith("conv_wgmma") and not (n > 0 and t > 0):
            _fail(f"{name}: no HGMMA or no UTMALDG in its SASS")
        # the paged kernel moves pages with async bulk copies
        if name.startswith("paged_chunk_kernel") and t == 0 and u == 0:
            _fail(f"{name}: no UTMALDG or UBLKCP (async bulk copy) in its "
                  f"SASS")
    if not any(k.startswith("paged_chunk_kernel") for k in sass or {}):
        _fail("no paged_chunk_kernel in the library's SASS (or no "
              "cuobjdump): its bulk copies cannot be checked")
    return info.seconds, sass


def _flash_cases(dev):
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    for tq, tk, causal, dtype in [(32, 32, True, f32), (128, 128, True, f32),
                                  (512, 512, True, f32),
                                  (128, 128, False, f32),
                                  (64, 256, True, f32),
                                  (512, 512, True, bf16)]:
        q = torch.randn(4, tq, 12, 64, device=dev, generator=gen).to(dtype)
        k = torch.randn(4, tk, 12, 64, device=dev, generator=gen).to(dtype)
        v = torch.randn(4, tk, 12, 64, device=dev, generator=gen).to(dtype)
        yield tq, tk, causal, dtype, q, k, v


def phase_flash(dev, tol=1e-4):
    import torch
    import torch.nn.functional as tF

    from paddle_tpu_torch.kernels import flash_attention as fa

    rows = []
    for tq, tk, causal, dtype, q, k, v in _flash_cases(dev):
        out, lse = fa.flash_attention_bthd(q, k, v, causal=causal,
                                           return_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                                return_lse=True)
        name = (f"B=4 Tq={tq} Tk={tk} H=12 D=64 causal={causal} "
                f"{str(dtype).split('.')[1]}")
        if dtype == torch.float32:
            err = max(float((out - ref).abs().max()),
                      float((lse - ref_lse).abs().max()))
            if not err <= tol:
                _fail(f"flash kernel {name}: max abs err {err} > {tol}")
        else:
            err = max(_max_err([out], [ref], dtype, f"flash kernel {name}"),
                      _max_err([lse], [ref_lse], torch.float32,
                               f"flash kernel {name} lse"))
        ms, eager_ms = _times(lambda: fa.flash_attention_bthd(q, k, v,
                                                              causal), 100)
        plain_ms, plain_eager_ms = _times(
            lambda: fa.flash_attention_plain(q, k, v, causal), 20, calls=5)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        mask = None
        if causal and tq != tk:   # SDPA's is_causal aligns top-left
            mask = torch.ones(tq, tk, dtype=torch.bool, device=dev).tril(
                tk - tq)
        lib_ms, lib_eager_ms = _times(lambda: tF.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask,
            is_causal=causal and mask is None), 100)
        bf16 = dtype == torch.bfloat16
        bound_ms, bound_by = _bound(
            *fa.flash_cost(4, tq, tk, 12, 64, causal, itemsize=2 if bf16
                           else 4), BF16_PEAK if bf16 else F32_PEAK)
        rows.append(dict(B=4, Tq=tq, Tk=tk, H=12, D=64, causal=causal,
                         dtype=str(dtype).split(".")[1], max_abs_err=err,
                         ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                         plain_eager_ms=plain_eager_ms, library_ms=lib_ms,
                         library_eager_ms=lib_eager_ms, bound_ms=bound_ms,
                         bound_by=bound_by))
        print(f"[flash] {name}: max_abs_err={err:.3e} kernel {ms:.4f} ms "
              f"(eager {eager_ms:.4f}), plain {plain_ms:.4f} ms (eager "
              f"{plain_eager_ms:.4f}), sdpa {lib_ms:.4f} ms (eager "
              f"{lib_eager_ms:.4f}), bound {bound_ms:.4f} ms ({bound_by})")
    return rows


# phase_paged's cases: (name, W, pool, n_pt, lengths of the 8 live rows);
# every case adds the scratch lane, parked at n_pt * P with an all-sentinel
# table, and runs at B=9 H=12 D=64 P=16
PAGED_CASES = (
    ("serve W=1 f32", 1, "f32", 40, (0, 15, 16, 37, 100, 255, 333, 600)),
    ("serve W=4 f32", 4, "f32", 40, (0, 15, 16, 37, 100, 255, 333, 600)),
    ("serve W=1 int8", 1, "int8", 40, (0, 15, 16, 37, 100, 255, 333, 600)),
    ("serve W=4 int8", 4, "int8", 40, (0, 15, 16, 37, 100, 255, 333, 600)),
    # every row near max_len 640: the pool's 320 pages nearly all live
    ("full pool W=1 f32", 1, "f32", 40,
     (560, 575, 590, 600, 610, 620, 630, 639)),
    # 8192 positions a row (n_pt 512), W=8: the table the whole-row kernel
    # refused for its shared-memory scores
    ("wide W=8 f32", 8, "f32", 512,
     (0, 100, 1000, 2047, 4096, 6000, 8000, 8184)),
)
PAGED_H, PAGED_D, PAGED_P = 12, 64, 16


def _paged_inputs(dev, case, n_sets):
    """One case of :data:`PAGED_CASES` at decode-step shapes: 8 rows and
    the parked scratch lane over a pool of 8 * n_pt pages; rows sit at a
    page start, on and next to a boundary and mid-page.  ``n_sets`` pool
    pairs (like the 12 layers of a step) keep the timed reads out of the
    50 MB L2."""
    import numpy as np
    import torch

    _, W, pool, n_pt, rows = case
    quant = pool == "int8"
    rs = np.random.RandomState(W + 2 * quant + n_pt)
    H, D, P = PAGED_H, PAGED_D, PAGED_P
    NP = 8 * n_pt
    lengths = np.array(list(rows) + [n_pt * P], np.int32)
    B = len(lengths)
    pt = np.full((B, n_pt), NP, np.int32)
    perm = rs.permutation(NP)
    used = 0
    for b, ln in enumerate(lengths[:-1]):
        need = -(-int(ln + W) // P)
        pt[b, :need] = perm[used:used + need]
        used += need
    gen = torch.Generator(device=dev).manual_seed(W + n_pt)
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
        sets.append((q, kp, vp, torch.from_numpy(pt).to(dev),
                     torch.from_numpy(lengths).to(dev), ks, vs))
    return lengths, sets


def _paged_n_sets(case):
    """Enough pool pairs that one rotation streams > 150 MB (the L2 holds
    50 MB), at least 2 and at most 8."""
    _, W, pool, n_pt, _ = case
    pair = 2 * 8 * n_pt * PAGED_P * PAGED_H * PAGED_D * (
        1 if pool == "int8" else 4)
    return max(2, min(8, -(-150_000_000 // pair)))


def paged_gather_sdpa(q, k_pages, v_pages, page_table, lengths,
                      k_scale=None, v_scale=None):
    """The yardstick of the paged kernel: gather every row's pages
    (``k_pages[pt_safe]``, int8 dequantized) and one
    ``scaled_dot_product_attention`` under the validity mask ``col <=
    start + row``.  Two calls: no single PyTorch call computes a paged
    read.  Timed beside the kernel only; the port never calls it."""
    import torch
    import torch.nn.functional as tF

    B, W, H, D = q.shape
    NP, P = k_pages.shape[:2]
    virt = page_table.shape[1] * P
    pt_safe = page_table.long().clamp(0, NP - 1)
    k = k_pages[pt_safe].reshape(B, virt, H, D)
    v = v_pages[pt_safe].reshape(B, virt, H, D)
    if k_scale is not None:
        k = k.float() * k_scale[pt_safe].reshape(B, virt, 1, 1)
        v = v.float() * v_scale[pt_safe].reshape(B, virt, 1, 1)
    cols = lengths.long()[:, None] + torch.arange(W, device=q.device)
    mask = torch.arange(virt, device=q.device) <= cols[:, :, None]
    out = tF.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask[:, None])
    return out.transpose(1, 2)


def phase_paged(dev, tol=1e-4):
    """Kernel 7 against its plain version at every case of
    :data:`PAGED_CASES`: device ms from CUDA-graph replays over rotating
    pool sets (eager ms beside), the plain version, the gather + SDPA
    yardstick and the bound (bytes)."""
    import torch

    from paddle_tpu_torch.kernels import paged_attention as pa

    rows = []
    for case in PAGED_CASES:
        name, W, pool, n_pt, _ = case
        lens_np, sets = _paged_inputs(dev, case, _paged_n_sets(case))
        live = sets[0][4] < n_pt * PAGED_P
        err = 0.0
        for args in sets[:2]:
            before = pa.paged_decode_attention.launches
            out = pa.paged_decode_attention(*args)
            torch.cuda.synchronize()
            if pa.paged_decode_attention.launches != before + 1:
                _fail(f"paged kernel {name}: launches did not rise by one")
            ref = pa.paged_decode_attention_plain(*args)
            err = max(err, float((out[live] - ref[live]).abs().max()))
            del out, ref
        if not err <= tol:
            _fail(f"paged kernel {name}: max abs err {err} > {tol}")
        ms, eager_ms = _times(_rotating(pa.paged_decode_attention, sets),
                              96)
        plain_ms, plain_eager_ms = _times(
            _rotating(pa.paged_decode_attention_plain, sets), 8, calls=4)
        lib_ms, lib_eager_ms = _times(_rotating(paged_gather_sdpa, sets), 8,
                                      calls=4)
        bound_ms, bound_by = _bound(*pa.paged_cost(
            lens_np, W, PAGED_H, PAGED_D, PAGED_P, n_pt, pool == "int8"))
        rows.append(dict(case=name, B=len(lens_np), W=W, H=PAGED_H,
                         D=PAGED_D, P=PAGED_P, n_pt=n_pt, pool=pool,
                         max_abs_err=err, ms=ms, eager_ms=eager_ms,
                         plain_ms=plain_ms, plain_eager_ms=plain_eager_ms,
                         library_ms=lib_ms, library_eager_ms=lib_eager_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        print(f"[paged] {name} (B={len(lens_np)} H={PAGED_H} D={PAGED_D} "
              f"P={PAGED_P} n_pt={n_pt}): max_abs_err={err:.3e} (tol "
              f"{tol}) kernel {ms:.4f} ms (eager {eager_ms:.4f}), plain "
              f"{plain_ms:.4f} ms (eager {plain_eager_ms:.4f}), gather + "
              f"sdpa {lib_ms:.4f} ms (eager {lib_eager_ms:.4f}), bound "
              f"{bound_ms:.4f} ms ({bound_by})")
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
    is None when the profiler saw no device activity; ``all_launches``
    counts each kernel name's launches.  The chrome trace goes to
    ``trace_path`` when one is given."""
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
    spans, by_name, n_by_name = [], {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            a, b = e.time_range.start, e.time_range.end
            spans.append((a, b))
            by_name[e.name] = by_name.get(e.name, 0.0) + (b - a)
            n_by_name[e.name] = n_by_name.get(e.name, 0) + 1
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return dict(window_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
                device_busy_share=busy / wall_us if spans else None,
                kernels_ms={k: v / 1e3 for k, v in ranked[:top]},
                all_kernels_ms={k: v / 1e3 for k, v in ranked},
                all_launches=n_by_name)


def _print_profile(tag, what, res):
    if res["device_busy_share"] is None:
        print(f"[{tag}] torch.profiler saw no device activity: device busy "
              f"share not measured")
        return
    print(f"[{tag}] {what}: window {res['window_ms']:.2f} ms, device busy "
          f"{res['device_busy_ms']:.2f} ms "
          f"({100 * res['device_busy_share']:.1f}% of the window)")
    for k, v in res["kernels_ms"].items():
        print(f"[{tag}]   {v:10.3f} ms  {k[:100]}")


def _profile(engine, prompts, new, trace_path):
    """A short serving window under :func:`_device_profile`, with the
    paged decode read's calls in it, its kernels' launches and device
    time (``paged_ms``)."""
    from paddle_tpu_torch.kernels import paged_attention as pa

    steps0 = engine.stats()["decode_steps"]
    calls0 = pa.paged_decode_attention.launches

    def window():
        for h in [engine.submit(p, max_new_tokens=new) for p in prompts]:
            h.result(timeout=600)

    res = _device_profile(window, trace_path)
    res["paged_calls"] = pa.paged_decode_attention.launches - calls0
    res["paged_ms"] = sum(v for k, v in res.pop("all_kernels_ms").items()
                          if "paged_" in k)
    res["paged_kernel_launches"] = sum(
        n for k, n in res.pop("all_launches").items() if "paged_" in k)
    res["decode_steps"] = engine.stats()["decode_steps"] - steps0
    _print_profile("profile", f"{len(prompts)} requests x {new} tokens, "
                   f"{res['decode_steps']} decode steps", res)
    return res


def phase_serve(dev, kv_dtype, n_req, new, seed, margin, profile=False,
                trace_path=None, ln_mode="off"):
    import numpy as np
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.models import build_gpt, load_jax_state
    from paddle_tpu_torch.serving import Engine

    tag = (f"serve{'-int8' if kv_dtype else ''}"
           f"{'-ln' if ln_mode != 'off' else ''}")
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
        with _toggles(ln_mode):
            # warm-up outside the counted run: cuBLAS handles, allocator
            engine.submit(prompts[0][:40], max_new_tokens=4).result(
                timeout=600)
            base = engine.stats()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.flash_attention_bthd.launches = 0
            pa.paged_decode_attention.launches = 0
            _ln_counters(zero=True)
            handles, outs, wall = _serve(engine, prompts, new, rs)
            flash_n = fa.flash_attention_bthd.launches
            paged_n = pa.paged_decode_attention.launches
            ln_n = _ln_counters()
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
    # every LayerNorm of a prefill batch or decode step is one kernel
    # forward with LayerNorm "full", none otherwise
    ln_want = dict(ln_matmul=0, ln_fwd=0, ln_bwd=0, ln_bwd_reduce=0)
    if ln_mode == "full":
        ln_want["ln_fwd"] = (prefills + steps) * (2 * N_LAYERS + 1)
    if ln_n != ln_want:
        _fail(f"{tag}: LayerNorm launches {ln_n} != {ln_want}")
    worst = _teacher_forced(cpu_model, prompts, outs, margin)
    ttft = sorted(h.ttft_s for h in handles)
    res = dict(kv_dtype=kv_dtype or "f32", requests=n_req, new_tokens=new,
               wall_s=wall, tokens_per_s=n_req * new / wall,
               p50_ttft_ms=1e3 * ttft[len(ttft) // 2],
               peak_memory_bytes=peak, prefill_batches=prefills,
               decode_steps=steps, flash_launches=flash_n,
               paged_launches=paged_n, ln_launches=ln_n,
               slot_reuses=st["slot_reuses"],
               prefill_batch_ms=prefill_ms / max(prefills, 1),
               decode_step_ms=decode_ms / max(steps, 1),
               teacher_forced_worst_gap=worst, margin=margin,
               model_build_s=t_build, profile=prof)
    print(f"[{tag}] {n_req} requests x {new} tokens in {wall:.3f} s: "
          f"{res['tokens_per_s']:.1f} tokens/s, p50 TTFT "
          f"{res['p50_ttft_ms']:.2f} ms, peak memory {peak / 2**20:.1f} "
          f"MiB; {prefills} prefill batches ({flash_n} flash launches), "
          f"{steps} decode steps ({paged_n} paged launches, "
          f"{ln_n['ln_fwd']} LayerNorm forward launches); teacher-forced"
          f" worst gap {worst:.3e} (margin {margin}); host wall per "
          f"prefill batch {res['prefill_batch_ms']:.3f} ms, per decode "
          f"step {res['decode_step_ms']:.3f} ms")
    return res


_PLAIN = (("flash_attention", ("flash_attention_plain",
                                "flash_attention_bwd_plain",
                                "flash_attention_qkv_fused_plain",
                                "flash_attention_qkv_fused_bwd_plain")),
          ("layer_norm", ("layer_norm_fwd_plain", "layer_norm_bwd_plain")),
          ("ln_matmul", ("ln_matmul_plain",)),
          ("conv_bn", ("fused_conv1x1_bn_plain", "fused3x3_plain",
                       "run_mm_plain", "run_pro_plain")))


@contextlib.contextmanager
def _no_plain():
    """Any call of a kernel's plain version inside raises: the path under
    test must launch the kernels."""
    import importlib

    saved = []
    for mod, names in _PLAIN:
        m = importlib.import_module(f"paddle_tpu_torch.kernels.{mod}")
        saved += [(m, n, getattr(m, n)) for n in names]

    def tripwire(name):
        def call(*args, **kwargs):
            raise RuntimeError(f"{name} ran on a path that must launch the "
                               f"CUDA kernels")
        return call

    for m, n, _ in saved:
        setattr(m, n, tripwire(n))
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


@contextlib.contextmanager
def _toggles(ln_mode="off", fused_proj=False):
    """The fused-LayerNorm toggles on for the block, off after it (an
    error passes through)."""
    from paddle_tpu_torch.kernels import layer_norm as ln
    from paddle_tpu_torch.kernels import ln_matmul as lnmm

    ln.enable_fused_layernorm(ln_mode)
    lnmm.enable_ln_matmul(fused_proj)
    try:
        yield
    finally:
        ln.enable_fused_layernorm(False)
        lnmm.enable_ln_matmul(False)


def _ln_counters(zero=False):
    """The LayerNorm launch counters (set to 0 first with ``zero``)."""
    from paddle_tpu_torch.kernels import layer_norm as ln
    from paddle_tpu_torch.kernels import ln_matmul as lnmm

    slots = [(lnmm.ln_matmul, "launches", "ln_matmul"),
             (ln.layer_norm_fused, "launches_fwd", "ln_fwd"),
             (ln.layer_norm_fused, "launches_bwd", "ln_bwd"),
             (ln.layer_norm_fused, "launches_bwd_reduce", "ln_bwd_reduce")]
    if zero:
        for fn, attr, _ in slots:
            setattr(fn, attr, 0)
    return {key: getattr(fn, attr) for fn, attr, key in slots}


def _attention_counters(zero=False):
    """The flash launch counters (set to 0 first with ``zero``)."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    slots = [(fa.flash_attention_bthd, "launches", "fwd"),
             (fa.flash_attention_qkv_fused, "launches", "fused_fwd"),
             (fa.flash_attention_bwd, "launches_delta", "bwd_delta"),
             (fa.flash_attention_bwd, "launches_dkv", "bwd_dkv"),
             (fa.flash_attention_bwd, "launches_dq", "bwd_dq"),
             (fa.flash_attention_qkv_fused_bwd, "launches_delta",
              "fused_bwd_delta"),
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
    """Device ms per call of each flash backward kernel in ``fn`` (delta,
    dk/dv, dq; f32 or bf16 instance), from ``torch.profiler``."""
    res = _device_profile(lambda: [fn() for _ in range(calls)])
    out = {"delta": 0.0, "dkv": 0.0, "dq": 0.0}
    for name, ms in res["all_kernels_ms"].items():
        for part in out:
            if f"flash_bwd_{part}_" in name:
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
    ms, eager_ms = _times(kern, iters)
    plain_ms, plain_eager_ms = _times(plain, plain_iters, calls=plain_iters,
                                      warmup=0)
    qh, kh, vh = (x.detach().transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    doh = do.reshape(B, tq, H, D).transpose(1, 2).contiguous()
    mask = None
    if causal and tq != tk:   # SDPA's is_causal aligns top-left
        mask = torch.ones(tq, tk, dtype=torch.bool, device=dev).tril(tk - tq)

    def library_fwd():
        return tF.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, is_causal=causal and mask is None)

    def library():
        return torch.autograd.grad(library_fwd(), (qh, kh, vh), doh)

    lib_ms, lib_eager_ms = _times(library, iters)
    lib_fwd_ms = _graph_ms(library_fwd, 10)
    item = 2 if dtype == torch.bfloat16 else 4
    peak = BF16_PEAK if dtype == torch.bfloat16 else F32_PEAK
    bound_ms, bound_by = _bound(
        *fa.flash_bwd_cost(B, tq, tk, H, D, causal, itemsize=item), peak)
    row = dict(B=B, Tq=tq, Tk=tk, H=H, D=D, dtype=str(dtype).split(".")[1],
               fused=fused, causal=causal, max_abs_err=err, ms=ms,
               eager_ms=eager_ms, plain_ms=plain_ms,
               plain_eager_ms=plain_eager_ms, library_ms=lib_ms,
               library_eager_ms=lib_eager_ms, library_fwd_ms=lib_fwd_ms,
               library_bwd_ms=lib_ms - lib_fwd_ms, bound_ms=bound_ms,
               bound_by=bound_by)
    parts = ""
    if split:
        row["kernel_ms"] = _split_ms(kern)
        for part in ("dq", "dkv"):
            row[f"bound_{part}"] = _bound(*fa.flash_bwd_cost(
                B, tq, tk, H, D, causal, itemsize=item, part=part), peak)
        parts = (f" (delta {row['kernel_ms']['delta']:.4f}, dk/dv "
                 f"{row['kernel_ms']['dkv']:.4f}, dq "
                 f"{row['kernel_ms']['dq']:.4f})")
    print(f"[flash-bwd] {name}: max_abs_err={err:.3e} kernel {ms:.4f} ms"
          f"{parts} (eager {eager_ms:.4f}), plain {plain_ms:.4f} ms (eager "
          f"{plain_eager_ms:.4f}), sdpa fwd+bwd {lib_ms:.4f} ms (eager "
          f"{lib_eager_ms:.4f}), sdpa bwd alone {lib_ms - lib_fwd_ms:.4f} "
          f"ms, bound {bound_ms:.4f} ms ({bound_by})")
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
    ms, eager_ms = _times(lambda: fa.flash_attention_qkv_fused(qkv), 20)
    plain_ms, plain_eager_ms = _times(
        lambda: fa.flash_attention_qkv_fused_plain(qkv), 2, calls=2,
        warmup=0)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in qkv.unbind(3))
    lib_ms, lib_eager_ms = _times(lambda: tF.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True), 20)
    flops, nbytes = fa.flash_cost(B, T, T, H, D, True, itemsize=2)
    bound_ms, bound_by = _bound(flops, nbytes, BF16_PEAK)
    print(f"[flash-fused-fwd] B={B} T={T} H={H} D={D} bf16 causal: "
          f"max_abs_err={err:.3e} kernel {ms:.4f} ms (eager {eager_ms:.4f}; "
          f"{flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms (eager "
          f"{plain_eager_ms:.4f}), sdpa {lib_ms:.4f} ms (eager "
          f"{lib_eager_ms:.4f}), bound {bound_ms:.4f} ms ({bound_by})")
    return dict(B=B, Tq=T, Tk=T, H=H, D=D, dtype="bfloat16", fused=True,
                causal=True, max_abs_err=err, ms=ms, eager_ms=eager_ms,
                plain_ms=plain_ms, plain_eager_ms=plain_eager_ms,
                library_ms=lib_ms, library_eager_ms=lib_eager_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                tflops=flops / ms / 1e9)


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


def phase_dead_rows(dev, shapes=((200, 120), (1100, 600), (2100, 1000),
                                  (3100, 1100))):
    """Causal Tq > Tk at the reference's tile boundaries: the rows with no
    live key through the kernels (the main kernels, then the dead-row pass
    each way) against the plain versions, f32 and bf16, B=1 H=4 D=64."""
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for tq, tk in shapes:
            q, k, v = (torch.randn(1, t, 4, 64, device=dev, generator=gen)
                       .to(dtype) for t in (tq, tk, tk))
            do = torch.randn(1, tq, 4, 64, device=dev, generator=gen).to(
                dtype)
            before = (fa.flash_attention_bthd.launches_dead,
                      fa.flash_attention_bwd.launches_dead)
            out, lse = fa.flash_attention_bthd(q, k, v, causal=True,
                                               return_lse=True)
            grads = fa.flash_attention_bwd(q, k, v, out, lse, do)
            torch.cuda.synchronize()
            n = (fa.flash_attention_bthd.launches_dead - before[0],
                 fa.flash_attention_bwd.launches_dead - before[1])
            name = f"Tq={tq} Tk={tk} {str(dtype).split('.')[1]}"
            if n != (1, 1):
                _fail(f"dead rows {name}: dead-row launches {n} != (1, 1)")
            ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=True,
                                                    return_lse=True)
            want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do)
            err = max(_max_err([out], [ref], dtype, f"dead rows {name} out"),
                      _max_err([lse], [ref_lse], torch.float32,
                               f"dead rows {name} lse"),
                      _max_err(grads, want, dtype, f"dead rows {name} grads"))
            rows.append(dict(Tq=tq, Tk=tk, dtype=str(dtype).split(".")[1],
                             max_abs_err=err, launches_dead=n))
            print(f"[dead-rows] B=1 H=4 D=64 causal {name}: rows "
                  f"0..{tq - tk - 1} with no live key, max_abs_err={err:.3e} "
                  f"(out, lse, dq, dk, dv against the plain versions), "
                  f"dead-row launches {n}")
    return rows


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
        want = dict(fwd=1, fused_fwd=0, bwd_delta=1, bwd_dkv=1, bwd_dq=1,
                    fused_bwd_delta=0, fused_bwd_dkv=0, fused_bwd_dq=0)
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


def _train_batch(dev, seed, batch, seq, vocab):
    """The bench's token batch from ``RandomState(seed)``: (x, y)."""
    import numpy as np
    import torch

    ids = np.random.RandomState(seed).randint(
        0, vocab, size=(batch, seq + 1)).astype(np.int64)
    return (torch.from_numpy(ids[:, :-1]).to(dev),
            torch.from_numpy(ids[:, 1:]).to(dev))


PLAIN_LOSS_RTOL = 1e-3


def _plain_attention_loss(dev, seed, batch, seq):
    """The loss of one bf16 step of phase 11's model (same seed, same
    batch) with the plain attention (``flash_attention_qkv_fused_plain``,
    differentiated by autograd) in place of the fused kernels; the flash
    launch counters must stay at 0."""
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.nn.functional import attention as att

    model = _train_model(dev, seed)
    step = _train_step(model, torch.bfloat16)
    x, y = _train_batch(dev, seed, batch, seq, model.config.vocab_size)
    kernel_fn = att.flash_attention_qkv_fused
    att.flash_attention_qkv_fused = (
        lambda qkv, causal=True, scale=None:
        fa.flash_attention_qkv_fused_plain(qkv, causal=causal, scale=scale))
    try:
        _attention_counters(zero=True)
        loss = float(step(x, y))
        n = _attention_counters()
    finally:
        att.flash_attention_qkv_fused = kernel_fn
    if any(n.values()):
        _fail(f"train with the plain attention launched kernels: {n}")
    del model, step
    torch.cuda.empty_cache()
    return loss


def _run_train(dev, seed, steps, batch, seq, ln_mode="off",
               fused_proj=False):
    """One warm-up and ``steps`` timed bf16 AdamW steps of full-width
    gpt2-small-en from the seed's weights and batch, under the given
    fused-LayerNorm toggles, with every launch counter set to 0 just
    before and read just after, and the plain versions tripped.  Returns
    the numbers and a function that runs one more step (toggles on)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models import gpt_train_flops_per_token

    model = _train_model(dev, seed)
    cfg = model.config
    if (cfg.hidden_size, cfg.num_layers, cfg.num_attention_heads,
            cfg.vocab_size) != (768, N_LAYERS, 12, 50304):
        _fail(f"gpt2-small-en is not at full width: {cfg}")
    step = _train_step(model, torch.bfloat16)
    x, y = _train_batch(dev, seed, batch, seq, cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _toggles(ln_mode, fused_proj):
        _attention_counters(zero=True)
        _ln_counters(zero=True)
        with _no_plain():
            losses = [float(step(x, y))]               # warm-up
            t0 = time.perf_counter()
            outs = [step(x, y) for _ in range(steps)]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        n = {**_attention_counters(), **_ln_counters()}
    peak = torch.cuda.max_memory_allocated()
    losses += [float(v) for v in outs]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        _fail(f"train (LayerNorm {ln_mode}, ln_matmul {fused_proj}): losses "
              f"{losses} are not finite and falling")
    if step.compile_count != 1:
        _fail(f"train: {step.compile_count} step builds for one signature")
    tokens_per_s = steps * batch * seq / wall
    share = tokens_per_s * gpt_train_flops_per_token(cfg, seq) / BF16_PEAK
    res = dict(batch=batch, seq=seq, steps=steps, ln_mode=ln_mode,
               ln_matmul=fused_proj, losses=losses,
               step_ms=1e3 * wall / steps, tokens_per_s=tokens_per_s,
               flops_share=share, peak_memory_bytes=peak, launches=n,
               launches_per_step={k: v // (steps + 1) for k, v in n.items()})

    def one_step():
        with _toggles(ln_mode, fused_proj):
            step(x, y)

    return res, one_step


def _want_launches(steps, ln=None):
    """Launch counts of ``steps`` training steps: 12 fused flash forwards
    and 12 of each backward kernel (delta, dk/dv, dq) a step, the
    LayerNorm counts ``ln`` a step (none by default), nothing else."""
    want = dict(fwd=0, fused_fwd=N_LAYERS, bwd_delta=0, bwd_dkv=0, bwd_dq=0,
                fused_bwd_delta=N_LAYERS, fused_bwd_dkv=N_LAYERS,
                fused_bwd_dq=N_LAYERS, ln_matmul=0,
                ln_fwd=0, ln_bwd=0, ln_bwd_reduce=0)
    want.update(ln or {})
    return {k: v * steps for k, v in want.items()}


def _print_train(tag, res, smi):
    print(f"[{tag}] gpt2-small-en B={res['batch']} T={res['seq']} bf16 "
          f"AdamW: losses {', '.join(f'{v:.6f}' for v in res['losses'])}")
    print(f"[{tag}] {res['step_ms']:.3f} ms a step, "
          f"{res['tokens_per_s']:.1f} tokens/s, flops share "
          f"{100 * res['flops_share']:.2f}% of the 989 TFLOP/s dense bf16 "
          f"peak (H100 SXM data sheet), peak memory "
          f"{res['peak_memory_bytes']} bytes, launches a step "
          f"{res['launches_per_step']} on {smi}")


def phase_train(dev, seed, smi, steps=5, batch=16, seq=1024):
    import torch

    res, one_step = _run_train(dev, seed, steps, batch, seq)
    if res["launches"] != _want_launches(steps + 1):
        _fail(f"train: launches {res['launches']} != "
              f"{_want_launches(steps + 1)}")
    prof = _device_profile(one_step)
    prof["attention_ms"] = sum(v for k, v in prof.pop(
        "all_kernels_ms").items() if "flash_" in k)
    res["profile"] = prof
    _print_train("train", res, smi)
    _print_profile("train-profile", "one step", prof)
    print(f"[train-profile] attention kernels (flash forward, delta, dk/dv, "
          f"dq): {prof['attention_ms']:.3f} ms of the step")
    del one_step
    torch.cuda.empty_cache()
    plain = _plain_attention_loss(dev, seed, batch, seq)
    rel = abs(plain - res["losses"][0]) / abs(res["losses"][0])
    res["plain_attention"] = dict(loss=plain, max_rel_diff=rel,
                                  tol=PLAIN_LOSS_RTOL)
    print(f"[train-plain] the first step with the plain attention: loss "
          f"{plain:.6f} against the kernels' {res['losses'][0]:.6f}, rel "
          f"diff {rel:.3e} (tol {PLAIN_LOSS_RTOL})")
    if not rel <= PLAIN_LOSS_RTOL:
        _fail(f"train: the plain-attention loss {plain} differs from the "
              f"kernel step's {res['losses'][0]} by {rel} > "
              f"{PLAIN_LOSS_RTOL}")
    return res


def phase_train_parity(dev, seed, tol=1e-4, fused_ln=False):
    """Three f32 steps of a 2-layer full-width model on the card and on
    the CPU from the same weights: the kernels against the plain
    versions through the whole step.  With ``fused_ln`` both
    fused-LayerNorm toggles are on (LayerNorm "full") on both sides, and
    the card must launch 4 ``ln_matmul`` and 5 LayerNorm forwards and
    backwards a step (one of each in every ``ln_matmul`` backward, and the
    final norm's)."""
    import numpy as np
    import torch

    tag = "parity-ln" if fused_ln else "parity"
    ids = np.random.RandomState(seed + 1).randint(
        0, 50304, size=(2, 1025)).astype(np.int64)
    losses = {}
    t0 = time.perf_counter()
    with _toggles("full" if fused_ln else "off", fused_ln):
        for where in (dev, torch.device("cpu")):
            step = _train_step(_train_model(where, seed, num_layers=2))
            _ln_counters(zero=True)
            losses[where.type] = [float(step(ids[:, :-1], ids[:, 1:]))
                                  for _ in range(3)]
            if where.type == "cuda":
                n_card = _ln_counters()
    want = {k: 0 for k in n_card}
    if fused_ln:
        want.update(ln_matmul=12, ln_fwd=15, ln_bwd=15, ln_bwd_reduce=15)
    if n_card != want:
        _fail(f"{tag}: LayerNorm launches on the card {n_card} != {want}")
    card, cpu = np.array(losses["cuda"]), np.array(losses["cpu"])
    rel = float(np.max(np.abs(card - cpu) / np.abs(cpu)))
    print(f"[{tag}] 2 layers, B=2 T=1024 f32: card {card.tolist()}, cpu "
          f"{cpu.tolist()}, max rel diff {rel:.3e} (tol {tol}), "
          f"LayerNorm launches {n_card}, {time.perf_counter() - t0:.1f} s")
    if not rel <= tol:
        _fail(f"{tag}: card and CPU losses differ by {rel} > {tol}")
    return dict(card=card.tolist(), cpu=cpu.tolist(), max_rel_diff=rel,
                tol=tol, ln_launches=n_card)


EPS = 1e-5
FUSED_LOSS_RTOL = 1e-3


def _sum_err(got, want, what):
    """Largest |got - want| of f32 column sums; fails past 1e-4 (1 +
    max|want|): sums of up to 16384 rows in another order."""
    err = 0.0
    for g, w in zip(got, want):
        d = (g.float() - w.float()).abs()
        tol = 1e-4 * (1.0 + float(w.float().abs().max()))
        if not float(d.max()) <= tol:
            _fail(f"{what}: max abs err {float(d.max())} past {tol}")
        err = max(err, float(d.max()))
    return err


def _graph_ms(fn, calls, replays=3):
    """Device ms of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events, so the
    kernels run back to back with no host time between them."""
    import torch

    # warm up on a side stream, as graph capture asks (autograd included)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    t1.synchronize()
    del graph
    return t0.elapsed_time(t1) / (replays * calls)


def _times(fn, iters, calls=10, warmup=3):
    """(device ms, call ms) of one call of ``fn``: from CUDA-graph replays
    (the kernels' own time), and CUDA events around ``iters`` back-to-back
    eager calls (what the caller waits: the host's time where the host is
    the slower side)."""
    call_ms = _timed_ms(fn, iters, warmup)
    return _graph_ms(fn, calls), call_ms


def _rotating(fn, sets):
    """``fn(*set)`` over the sets in turn, one set a call."""
    it = [0]

    def call():
        args = sets[it[0] % len(sets)]
        it[0] += 1
        return fn(*args)
    return call


def phase_layernorm(dev):
    """Kernels 9 and 10 against their plain versions; times, library
    yardsticks and bounds.  The backward is compared on the kernel's own
    statistics, so it checks the backward alone."""
    import torch
    import torch.nn.functional as tF

    from paddle_tpu_torch.kernels import layer_norm as ln

    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    bf16, f32 = torch.bfloat16, torch.float32
    # (N, C, x's type, dy's type): the training step's width, then rows
    # wider than a lane's registers hold (the wide kernels), then the
    # ln_matmul backward's f32 dy beside bf16 x
    for N, C, dtype, dy_dtype in (
            (16384, 768, bf16, bf16), (16384, 768, f32, f32),
            (1000, 768, bf16, bf16), (1000, 768, f32, f32),
            (8, 768, bf16, bf16), (8, 768, f32, f32),
            (4096, 1280, f32, f32), (4096, 2560, bf16, bf16),
            (4096, 4096, f32, f32), (4096, 8192, bf16, bf16),
            (16384, 768, bf16, f32)):
        item = 2 if dtype == torch.bfloat16 else 4
        dy_item = 2 if dy_dtype == torch.bfloat16 else 4
        # enough input sets that one rotation streams > 150 MB: the 50 MB
        # L2 does not hold the next call's rows
        n_sets = max(2, min(8, -(-150_000_000 // (2 * N * C * item))))
        sets = [(torch.randn(N, C, device=dev, generator=gen).to(dtype),
                 torch.randn(N, C, device=dev, generator=gen).to(dy_dtype))
                for _ in range(n_sets)]
        w = (1 + 0.1 * torch.randn(C, device=dev, generator=gen)).to(dtype)
        b = (0.1 * torch.randn(C, device=dev, generator=gen)).to(dtype)
        stats = [ln.layer_norm_fwd(x, w, b, EPS)[1:] for x, _ in sets]
        x, dy = sets[0]
        mu, rs = stats[0]
        y = ln.layer_norm_fwd(x, w, b, EPS)[0]
        dx, dw, db = ln.layer_norm_bwd(x, w, mu, rs, dy)
        torch.cuda.synchronize()
        yp, mup, rsp = ln.layer_norm_fwd_plain(x, w, b, EPS)
        dxp, dwp, dbp = ln.layer_norm_bwd_plain(x, w, mu, rs, dy)
        name = f"N={N} C={C} {str(dtype).split('.')[1]}" + (
            " dy float32" if dy_dtype != dtype else "")
        err_f = max(_max_err([y], [yp], dtype, f"LayerNorm forward {name}"),
                    _max_err([mu, rs], [mup, rsp], torch.float32,
                             f"LayerNorm statistics {name}"))
        err_b = max(_max_err([dx], [dxp], dtype, f"LayerNorm dx {name}"),
                    _sum_err([dw, db], [dwp, dbp], f"LayerNorm dw/db {name}"))
        del yp, mup, rsp, dxp, dwp, dbp
        bwd_sets = [(x_, dy_, *st) for (x_, dy_), st in zip(sets, stats)]
        fwd = _times(_rotating(
            lambda x_, dy_: ln.layer_norm_fwd(x_, w, b, EPS), sets), 100)
        fwd_plain = _times(_rotating(
            lambda x_, dy_: ln.layer_norm_fwd_plain(x_, w, b, EPS), sets), 20,
            calls=3)
        fwd_lib = _times(_rotating(
            lambda x_, dy_: tF.layer_norm(x_, (C,), w, b, EPS), sets), 100)
        bwd = _times(_rotating(lambda x_, dy_, m_, r_: ln.layer_norm_bwd(
            x_, w, m_, r_, dy_), bwd_sets), 100)
        bwd_plain = _times(_rotating(
            lambda x_, dy_, m_, r_: ln.layer_norm_bwd_plain(x_, w, m_, r_,
                                                            dy_),
            bwd_sets), 20, calls=3)
        wr, br = (t.detach().clone().requires_grad_() for t in (w, b))
        lib_sets = [(x_.detach().clone().requires_grad_(), dy_)
                    for x_, dy_ in sets]

        def lib_bwd(xr, dy_):
            out = tF.layer_norm(xr, (C,), wr, br, EPS)
            return torch.autograd.grad(out, (xr, wr, br), dy_.to(out.dtype))

        bwd_lib = _times(_rotating(lib_bwd, lib_sets), 50, calls=3)
        for part, err, ms, plain_ms, lib_ms in (
                ("fwd", err_f, fwd, fwd_plain, fwd_lib),
                ("bwd", err_b, bwd, bwd_plain, bwd_lib)):
            bound_ms, bound_by = _bound(*ln.layernorm_cost(
                N, C, item, part, dy_itemsize=dy_item))
            row = dict(N=N, C=C, dtype=str(dtype).split(".")[1], part=part,
                       dy_dtype=str(dy_dtype).split(".")[1],
                       max_abs_err=err, ms=ms[0], call_ms=ms[1],
                       plain_ms=plain_ms[0], plain_call_ms=plain_ms[1],
                       library_ms=lib_ms[0], library_call_ms=lib_ms[1],
                       bound_ms=bound_ms, bound_by=bound_by, n_sets=n_sets)
            rows.append(row)
            print(f"[layernorm-{part}] {name}: max_abs_err={err:.3e} device "
                  f"ms (a call's ms): kernel {ms[0]:.4f} ({ms[1]:.4f})"
                  f", plain {plain_ms[0]:.4f} ({plain_ms[1]:.4f}), "
                  f"F.layer_norm{' fwd+bwd' if part == 'bwd' else ''} "
                  f"{lib_ms[0]:.4f} ({lib_ms[1]:.4f}), bound {bound_ms:.4f} "
                  f"({bound_by}), {n_sets} input sets")
        del sets, stats, bwd_sets, lib_sets
        torch.cuda.empty_cache()
    return rows


def phase_ln_matmul(dev, sass):
    """Kernel 8 against its plain version at the training step's two
    projections, the widths 1280 and 1024 (GPT-2-large's and -medium's
    qkv and fc0 shapes, fewer rows), the f32 path and the decode rows;
    times, TFLOP/s and bounds, and the bf16 kernel's ``HGMMA`` and
    ``UTMALDG`` counts from phase 2.  Inputs at a layer's scales: g ~ 1,
    b ~ 0, W ~ 1/sqrt(K)."""
    import torch
    import torch.nn.functional as tF

    from paddle_tpu_torch.kernels import ln_matmul as lnmm

    counts = {k: v[:2] for k, v in (sass or {}).items()
              if k.startswith("ln_matmul_wgmma")}
    print(f"[ln-matmul] bf16 kernel SASS (HGMMA, UTMALDG): "
          f"{counts or 'cuobjdump not found'}")
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = []
    for N, K, M, dtype in ((16384, 768, 2304, torch.bfloat16),
                           (16384, 768, 3072, torch.bfloat16),
                           (4096, 1280, 3840, torch.bfloat16),
                           (2048, 1024, 4096, torch.bfloat16),
                           (300, 768, 2304, torch.float32),
                           (8, 768, 2304, torch.bfloat16)):
        x = torch.randn(N, K, device=dev, generator=gen).to(dtype)
        w = (torch.randn(M, K, device=dev, generator=gen) / K ** 0.5).to(dtype)
        g = (1 + 0.1 * torch.randn(K, device=dev, generator=gen)).to(dtype)
        b = (0.1 * torch.randn(K, device=dev, generator=gen)).to(dtype)
        got = lnmm.ln_matmul(x, g, b, w, eps=EPS)
        torch.cuda.synchronize()
        want = lnmm.ln_matmul_plain(x, g, b, w, EPS)
        name = f"N={N} K={K} M={M} {str(dtype).split('.')[1]}"
        err = _max_err([got], [want], dtype, f"ln_matmul {name}")
        del got, want
        ms = _times(lambda: lnmm.ln_matmul(x, g, b, w, eps=EPS), 20, calls=5)
        plain_ms = _times(lambda: lnmm.ln_matmul_plain(x, g, b, w, EPS), 3,
                          calls=2, warmup=1)
        lib_ms = _times(lambda: torch.matmul(
            tF.layer_norm(x, (K,), g, b, EPS), w.t()), 20, calls=5)
        item = 2 if dtype == torch.bfloat16 else 4
        peak = BF16_PEAK if dtype == torch.bfloat16 else F32_PEAK
        flops, nbytes = lnmm.ln_matmul_cost(N, K, M, item)
        bound_ms, bound_by = _bound(flops, nbytes, peak)
        rows.append(dict(N=N, K=K, M=M, dtype=str(dtype).split(".")[1],
                         max_abs_err=err, ms=ms[0], call_ms=ms[1],
                         plain_ms=plain_ms[0], plain_call_ms=plain_ms[1],
                         library_ms=lib_ms[0], library_call_ms=lib_ms[1],
                         bound_ms=bound_ms, bound_by=bound_by,
                         tflops=flops / ms[0] / 1e9,
                         sass=counts if dtype == torch.bfloat16 else None))
        print(f"[ln-matmul] {name}: max_abs_err={err:.3e} device ms (a "
              f"call's ms): kernel {ms[0]:.4f} ({ms[1]:.4f}; "
              f"{flops / ms[0] / 1e9:.1f} TFLOP/s), plain {plain_ms[0]:.4f} "
              f"({plain_ms[1]:.4f}), F.layer_norm + matmul {lib_ms[0]:.4f} "
              f"({lib_ms[1]:.4f}), bound {bound_ms:.4f} ({bound_by})")
        del x, w
        torch.cuda.empty_cache()
    return rows


def phase_fused_train(dev, seed, smi, base_losses, steps=5, batch=16,
                      seq=1024):
    """Phase 11's step with the fused-LayerNorm toggles: both on (the
    main configuration: ``norm1 -> qkv`` and ``norm2 -> fc0`` through
    ``ln_matmul``, the final norm through the LayerNorm kernels), then
    LayerNorm "full" alone and "bwd" alone.  Losses are held against
    phase 11's from the same weights and batch within FUSED_LOSS_RTOL: the
    two round to bf16 at other places (the normalised rows from other
    statistics; the ``ln_matmul`` backward's f32 LayerNorm arithmetic), and
    on an H100 80GB HBM3 (700 W) the six both-on losses stayed within
    1.8e-4 of the unfused ones, the alone configurations within 3.2e-5."""
    import numpy as np
    import torch

    L = N_LAYERS
    # both on: each ln_matmul backward runs one LayerNorm forward (xln) and
    # one backward (dx kernel and column sum); the final norm one more
    configs = (("both", "full", True, steps,
                dict(ln_matmul=2 * L, ln_fwd=2 * L + 1, ln_bwd=2 * L + 1,
                     ln_bwd_reduce=2 * L + 1)),
               ("ln-full", "full", False, 2,
                dict(ln_fwd=2 * L + 1, ln_bwd=2 * L + 1,
                     ln_bwd_reduce=2 * L + 1)),
               ("ln-bwd", "bwd", False, 2,
                dict(ln_bwd=2 * L + 1, ln_bwd_reduce=2 * L + 1)))
    out = {}
    for name, mode, proj, n_steps, per_step in configs:
        res, one_step = _run_train(dev, seed, n_steps, batch, seq,
                                   ln_mode=mode, fused_proj=proj)
        want = _want_launches(n_steps + 1, per_step)
        if res["launches"] != want:
            _fail(f"train-{name}: launches {res['launches']} != {want}")
        ours = np.array(res["losses"])
        ref = np.array(base_losses[:len(ours)])
        res["max_rel_diff_vs_unfused"] = rel = float(
            np.max(np.abs(ours - ref) / np.abs(ref)))
        _print_train(f"train-{name}", res, smi)
        print(f"[train-{name}] losses against the unfused step's: max rel "
              f"diff {rel:.3e} (tol {FUSED_LOSS_RTOL})")
        if not rel <= FUSED_LOSS_RTOL:
            _fail(f"train-{name}: losses {ours.tolist()} differ from the "
                  f"unfused {ref.tolist()} by {rel} > {FUSED_LOSS_RTOL}")
        if name == "both":
            prof = _device_profile(one_step)
            kernels = prof.pop("all_kernels_ms")
            prof["ln_kernels_ms"] = {
                part: sum(v for k, v in kernels.items() if part in k)
                for part in ("ln_stats_kernel", "ln_matmul_wgmma_kernel",
                             "ln_fwd_kernel", "ln_bwd_kernel",
                             "colsum2_kernel")}
            prof["ln_matmul_ms"] = (prof["ln_kernels_ms"]["ln_stats_kernel"]
                                    + prof["ln_kernels_ms"][
                                        "ln_matmul_wgmma_kernel"])
            # the step's kernels by device time, the backward's cuBLAS
            # products among them
            prof["kernels_ms"] = dict(list(kernels.items())[:25])
            res["profile"] = prof
            _print_profile("train-both-profile", "one step", prof)
            print(f"[train-both-profile] LayerNorm kernels in the step: "
                  f"{prof['ln_kernels_ms']}; ln_matmul (statistics + "
                  f"product) {prof['ln_matmul_ms']:.3f} ms a step")
        out[name] = res
        del one_step
        torch.cuda.empty_cache()
    return out


# the experiment scripts' shapes: tools/exp_conv_bn.py:123-133 (M, K, N),
# tools/exp_conv3x3.py:94-95 (n, H, W, C, Co), tools/exp_conv_bn2.py:100
# (M rounded up to a multiple of 1024, as its main does)
CONV1X1_SHAPES = ((64 * 56 * 56, 64, 256), (64 * 56 * 56, 256, 64),
                  (64 * 28 * 28, 512, 128), (64 * 28 * 28, 128, 512),
                  (64 * 14 * 14, 1024, 256), (64 * 14 * 14, 256, 1024),
                  (64 * 7 * 7, 2048, 512), (64 * 7 * 7, 512, 2048))
CONV3X3_SHAPES = ((64, 56, 56, 64, 64), (64, 28, 28, 128, 128),
                  (64, 14, 14, 256, 256), (64, 7, 7, 512, 512))
SPLIT_SHAPES = tuple((-(-m // 1024) * 1024, k, n) for m, k, n in
                     ((50176, 512, 128), (12544, 1024, 256),
                      (200704, 64, 256)))


def _conv_inputs(gen, dev, x_shape, C, w_shape, fan_in, b_pos=False):
    """The scripts' inputs: x ~ N(0, 1) bf16, s ~ 1 + 0.1 N, b ~ 0.1 N
    (or 0.5 + |0.1 N| with ``b_pos``, so that relu(b) > 0 at a zero
    tap), w ~ N(0, 1/fan_in) bf16."""
    import torch

    x = torch.randn(x_shape, device=dev, generator=gen).to(torch.bfloat16)
    s = 1 + 0.1 * torch.randn(C, device=dev, generator=gen)
    b = 0.1 * torch.randn(C, device=dev, generator=gen)
    if b_pos:
        b = 0.5 + b.abs()
    w = (torch.randn(w_shape, device=dev, generator=gen)
         / fan_in ** 0.5).to(torch.bfloat16)
    return x, s, b, w


def _stats_check(got, want, y, what):
    """The kernel's f32 statistics ``[sum y, sum y^2]`` against the plain
    version's, each row at 1e-4 (1 + its own max |want|); and, over all
    columns of each row, nearer to the plain version's sums of the f32
    accumulator than to the sums of its bf16-rounded ``y`` (the statistics
    of the scripts' ``xla_chain``).  Returns (max abs err, the tolerance
    of the row it fell in, [L1 distance to the f32 sums, to the rounded
    sums] of each row)."""
    yf = y.float().reshape(-1, y.shape[-1])
    rounded = (yf.sum(dim=0), (yf * yf).sum(dim=0))
    err, tol, gaps = 0.0, 0.0, []
    for r, name in enumerate(("sum y", "sum y^2")):
        g, w = got[r].float(), want[r].float()
        d = float((g - w).abs().max())
        t = 1e-4 * (1.0 + float(w.abs().max()))
        if not d <= t:
            _fail(f"{what} {name}: max abs err {d} past {t}")
        gap = (float((g - w).abs().sum()),
               float((g - rounded[r]).abs().sum()))
        if not gap[0] < gap[1]:
            _fail(f"{what} {name}: L1 distance {gap[0]} to the sums of the "
                  f"f32 accumulator is not below {gap[1]} to the sums of "
                  f"the rounded y")
        if tol == 0.0 or d / t >= err / tol:
            err, tol = d, t
        gaps.append(gap)
    return err, tol, gaps


_FUSED = {}


def _fused_ops():
    """The yardstick's element-wise parts, each one kernel as XLA fused
    the scripts' ``xla_chain`` under ``jax.jit``: the prologue ``relu(x2
    s + b)`` rounded to x's type over ``[M, K]`` rows, and the f32 column
    sums ``(sum y, sum y^2)`` of a ``[M, N]`` y.  Compiled by TorchInductor
    with dynamic shapes (one build for every shape), in this process (no
    compile workers).  Only the yardstick runs them."""
    import torch

    if not _FUSED:
        import torch._inductor.config as inductor_config

        inductor_config.compile_threads = 1

        def prologue(x2, s, b):
            return torch.relu(x2.float() * s + b).to(x2.dtype)

        def sums(y2):
            yf = y2.float()
            return yf.sum(dim=0), (yf * yf).sum(dim=0)

        _FUSED["prologue"] = torch.compile(prologue, dynamic=True)
        _FUSED["sums"] = torch.compile(sums, dynamic=True)
    return _FUSED["prologue"], _FUSED["sums"]


def _yardstick_1x1(prologue, stats):
    """The library yardstick of a 1x1 variant: the fused prologue (if
    any), ``torch.matmul`` (cuBLAS), the fused sums of its output (if
    any)."""
    import torch

    pro, sums = _fused_ops()

    def call(x, s, b, w):
        y = torch.matmul(pro(x, s, b) if prologue else x, w)
        return (y, sums(y)) if stats else y
    return call


def _yardstick_3x3(x, s, b, wl):
    """The library yardstick of ``fused3x3``: the fused prologue, cuDNN's
    ``conv2d`` (channels_last, SAME) with ``wl``, the weight laid out once
    as OIHW channels_last, and the fused sums of its output."""
    import torch.nn.functional as tF

    pro, sums = _fused_ops()
    n, H, W, C = x.shape
    xn = pro(x.reshape(-1, C), s, b).view(n, H, W, C).permute(0, 3, 1, 2)
    y = tF.conv2d(xn, wl, padding=1)
    return y, sums(y.permute(0, 2, 3, 1).reshape(-1, wl.shape[0]))


def _conv_case(tag, name, kernel, plain, library, chain, sets, flops,
               nbytes, stats, lib_sets=None):
    """One conv+BN case: the kernel against its plain version on the
    first input set (bf16 y at the bf16 tolerance, the f32 statistics by
    ``_stats_check``), then device ms of kernel, plain version, the fused
    library yardstick (over ``lib_sets``, the same inputs laid out for the
    library, where given) and the scripts' eager chain from CUDA-graph
    replays over the rotating sets, and the bound at the bf16 peak."""
    import torch

    before = _route_counts()
    got = kernel(*sets[0])
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in _route_counts().items()}
    route = [k for k, v in moved.items() if v] or ["none"]
    if len(route) != 1:
        _fail(f"{tag} {name}: one call moved the route counters {moved}")
    route = route[0]
    want = plain(*sets[0])
    if not stats:
        got, want = (got, None), (want, None)
    err_y = _max_err([got[0]], [want[0]], torch.bfloat16, f"{tag} y {name}")
    err_s, tol_s, gaps = (_stats_check(got[1], want[1], want[0],
                                       f"{tag} stats {name}") if stats
                          else (None, None, None))
    del got, want
    ms = _times(_rotating(kernel, sets), 20, calls=10)
    plain_ms = _times(_rotating(plain, sets), 3, calls=2, warmup=1)
    lib_ms = _times(_rotating(library, lib_sets or sets), 20, calls=10)
    chain_ms = _times(_rotating(chain, sets), 20, calls=10)
    bound_ms, bound_by = _bound(flops, nbytes, BF16_PEAK)
    row = dict(case=tag, shape=name, route=route, max_abs_err=err_y,
               stats_abs_err=err_s, stats_tol=tol_s, stats_l1_gaps=gaps,
               ms=ms[0], call_ms=ms[1], plain_ms=plain_ms[0],
               plain_call_ms=plain_ms[1], library_ms=lib_ms[0],
               library_call_ms=lib_ms[1], chain_ms=chain_ms[0],
               chain_call_ms=chain_ms[1], bound_ms=bound_ms,
               bound_by=bound_by, n_sets=len(sets),
               tflops=flops / ms[0] / 1e9)
    st = ("" if err_s is None else
          f" stats {err_s:.3e} (tol {tol_s:.3e}; L1 to the f32 sums / to "
          f"the rounded-y sums: "
          + ", ".join(f"{a:.3e}/{b:.3e}" for a, b in gaps) + ")")
    print(f"[conv-bn] {tag} {name} [{route}]: err y {err_y:.3e}{st}; "
          f"device ms (a "
          f"call's ms): kernel {ms[0]:.4f} ({ms[1]:.4f}; "
          f"{row['tflops']:.1f} TFLOP/s), plain {plain_ms[0]:.4f}, fused "
          f"library {lib_ms[0]:.4f} ({lib_ms[1]:.4f}), eager chain "
          f"{chain_ms[0]:.4f}, bound {bound_ms:.4f} ({bound_by}), "
          f"{len(sets)} input sets")
    return row


def _route_counts():
    """The conv+BN launch counters by route: ``wgmma`` (the four entry
    points' ``launches_wgmma``) and ``mma`` (``fused3x3.launches_mma``)."""
    from paddle_tpu_torch.kernels import conv_bn as cb

    return dict(wgmma=sum(f.launches_wgmma for f in (
        cb.fused_conv1x1_bn, cb.fused3x3, cb.run_mm, cb.run_pro)),
        mma=cb.fused3x3.launches_mma)


def _n_sets(nbytes):
    """Input sets whose rotation streams > 150 MB, so the 50 MB L2 does
    not hold the next call's operands."""
    return max(2, min(8, -(-150_000_000 // int(nbytes))))


def phase_conv_bn(dev):
    """Kernels 11-13 against their plain versions at every shape of the
    three experiment scripts, a ragged M and a 3x3 with b > 0 at the
    border; device ms of kernel, plain version, the fused library
    yardstick (``_fused_ops`` around ``torch.matmul`` or cuDNN's
    ``conv2d``) and the scripts' ``xla_chain`` run eagerly
    (``chain_1x1``/``chain_3x3``, or ``torch.matmul`` for the bare
    product), with the bound.  ``cudnn.benchmark`` is on for the phase."""
    import torch

    from paddle_tpu_torch.kernels import conv_bn as cb

    gen = torch.Generator(device=dev).manual_seed(18)
    rows = []
    sms = cb._sms(dev)

    def one_by_one(M, K, N, variants):
        flops, nbytes = cb.conv1x1_cost(M, K, N)
        sets = [_conv_inputs(gen, dev, (M, K), K, (K, N), K)
                for _ in range(_n_sets(nbytes))]
        name = f"M={M} K={K} N={N}"
        for tag in variants:
            pro, st = tag in ("full", "pro"), tag in ("full", "stat")
            f, nb = cb.conv1x1_cost(M, K, N, prologue=pro, stats=st)
            if tag == "full":
                case = (lambda x, s, b, w: cb.fused_conv1x1_bn(x, s, b, w),
                        cb.fused_conv1x1_bn_plain, cb.chain_1x1)
            elif tag == "pro":
                case = (lambda x, s, b, w: cb.run_pro(x, s, b, w),
                        cb.run_pro_plain, cb.chain_1x1)
            elif tag == "stat":
                case = (lambda x, s, b, w: cb.run_mm(
                            x, w, kern=cb._k_stat, nstat=True),
                        lambda x, s, b, w: cb.run_mm_plain(x, w, stats=True),
                        lambda x, s, b, w: torch.matmul(x, w))
            else:
                case = (lambda x, s, b, w: cb.run_mm(x, w),
                        lambda x, s, b, w: cb.run_mm_plain(x, w),
                        lambda x, s, b, w: torch.matmul(x, w))
            kernel, plain, chain = case
            rows.append(_conv_case(tag, name, kernel, plain,
                                   _yardstick_1x1(pro, st), chain, sets, f,
                                   nb, st))
            rows[-1].update(M=M, K=K, N=N, kernel=tag,
                            tile=_tile(cb.conv_plan(M, N, sms=sms)))
        del sets
        torch.cuda.empty_cache()

    bench0 = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    print("[conv-bn] cudnn.benchmark on, TF32 off; the fused library "
          "yardstick: TorchInductor's prologue and column sums around "
          "cuBLAS / cuDNN (channels_last)")
    try:
        for M, K, N in CONV1X1_SHAPES:
            one_by_one(M, K, N, ("full",))
        for M, K, N in SPLIT_SHAPES:
            one_by_one(M, K, N, ("mm", "stat", "pro", "full"))
        one_by_one(12345, 256, 64, ("full",))          # ragged M
        cases3 = [(s, False) for s in CONV3X3_SHAPES] + [
            ((8, 14, 14, 256, 256), True)]
        for (n, H, W, C, Co), b_pos in cases3:
            flops, nbytes = cb.conv3x3_cost(n, H, W, C, Co)
            sets = [_conv_inputs(gen, dev, (n, H, W, C), C, (3, 3, C, Co),
                                 9 * C, b_pos) for _ in range(_n_sets(nbytes))]
            lib_sets = [(x, s, b, w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)) for x, s, b, w in sets]
            name = f"n={n} {H}x{W} C={C}->{Co}{' b>0' if b_pos else ''}"
            rows.append(_conv_case("3x3", name, cb.fused3x3,
                                   cb.fused3x3_plain, _yardstick_3x3,
                                   cb.chain_3x3, sets, flops, nbytes, True,
                                   lib_sets))
            rows[-1].update(n=n, H=H, W=W, C=C, Co=Co, kernel="3x3",
                            b_pos=b_pos, tile=_tile(cb.conv_plan(
                                n * H * W, Co, C, sms=sms)))
            del sets, lib_sets
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.benchmark = bench0
    off = [f"{r['case']} {r['shape']}" for r in rows if r["route"] != "wgmma"]
    if off:
        _fail(f"conv-bn: script shapes off the wgmma route: {off}")
    return rows


def _tile(plan):
    return (f"{plan['bm']}x{plan['bn']}, {plan['groups']} groups"
            if plan["route"] == "wgmma" else f"mma {plan['bm']}x{plan['bn']}")


def _resnet_state(model, seed):
    """A JAX-layout numpy state for a ResNet from numpy's generator:
    conv weights N(0, 2 / fan_in), ``fc`` weight N(0, 0.01^2), zero
    biases, unit batch-norm scales except the last of each bottleneck
    (``bn3``: zero, so each residual branch starts as the identity, the
    usual start for lr 0.1 at this batch), running mean 0 and variance
    1."""
    import numpy as np

    from paddle_tpu_torch.models import to_jax_state

    rng = np.random.default_rng(seed)
    state = {}
    for name, arr in to_jax_state(model).items():
        if arr.ndim == 4:
            std = np.sqrt(2.0 / np.prod(arr.shape[1:]))
        elif name == "fc.weight":
            std = 0.01
        else:
            fill = 1.0 if name.endswith(("_variance", "weight")) else 0.0
            if name.endswith("bn3.weight"):
                fill = 0.0
            state[name] = np.full(arr.shape, fill, np.float32)
            continue
        state[name] = (rng.standard_normal(arr.shape, dtype=np.float32)
                       * np.float32(std))
    return state


def _resnet_step(model, compute_dtype=None):
    """The bench's step: Momentum(0.1, 0.9, L2 1e-4), CrossEntropyLoss."""
    from paddle_tpu_torch.distributed import make_train_step
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum

    opt = Momentum(learning_rate=0.1, momentum=0.9, parameters=model,
                   weight_decay=1e-4)
    return make_train_step(model, opt, loss_fn=CrossEntropyLoss(),
                           compute_dtype=compute_dtype)


def _conv_bn_counters(zero=False):
    """The conv+BN launch counters (set to 0 first with ``zero``)."""
    from paddle_tpu_torch.kernels import conv_bn as cb

    slots = [(cb.fused_conv1x1_bn, "launches", "fused_conv1x1_bn"),
             (cb.fused3x3, "launches", "fused3x3"),
             (cb.run_mm, "launches", "run_mm"),
             (cb.run_mm, "launches_mm", "run_mm _k_mm"),
             (cb.run_mm, "launches_stat", "run_mm _k_stat"),
             (cb.run_pro, "launches", "run_pro"),
             (cb.conv_bn_column_sum, "launches", "conv_bn_column_sum"),
             (cb.conv_bn_prologue, "launches", "conv_bn_prologue"),
             (cb.fused_conv1x1_bn, "launches_wgmma", "fused_conv1x1_bn wgmma"),
             (cb.fused3x3, "launches_wgmma", "fused3x3 wgmma"),
             (cb.fused3x3, "launches_mma", "fused3x3 mma"),
             (cb.run_mm, "launches_wgmma", "run_mm wgmma"),
             (cb.run_pro, "launches_wgmma", "run_pro wgmma")]
    if zero:
        for fn, attr, _ in slots:
            setattr(fn, attr, 0)
    return {key: getattr(fn, attr) for fn, attr, key in slots}


def _resnet_batch(dev, seed, batch, size, channels_last):
    """One batch as ``bench.py:415-427`` makes it: f32 N(0, 1) images and
    int64 labels below 1000 from ``RandomState(seed)``."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.standard_normal(
        (batch, 3, size, size)).astype(np.float32)).to(dev)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    y = torch.from_numpy(rng.randint(0, 1000, (batch,)).astype(
        np.int64)).to(dev)
    return x, y


# kernel-name fragments by kind, first match wins: the convolutions
# (cuDNN / CUTLASS implicit GEMMs), the optimizer's foreach updates, the
# reductions (batch-norm statistics and their gradients), pooling, and
# the element-wise passes (batch-norm apply, relu, casts, adds)
_KINDS = (("conv, gemm", ("conv", "xmma", "cudnn", "gemm", "implicit",
                          "cutlass", "sm90_", "nchwToNhwc", "nhwcToNchw")),
          ("optimizer", ("multi_tensor_apply",)),
          ("reduction", ("reduce_kernel",)),
          ("pooling", ("pool",)),
          ("element-wise", ("elementwise", "copy", "Functor", "fill")))


def _kernel_kinds(kernels_ms):
    """Device ms of ``{kernel name: ms}`` summed by ``_KINDS`` (the rest
    under "other")."""
    out = {k: 0.0 for k, _ in _KINDS}
    out["other"] = 0.0
    for name, ms in kernels_ms.items():
        kind = next((k for k, frags in _KINDS
                     if any(f in name for f in frags)), "other")
        out[kind] += ms
    return out


def _resnet50(dev, seed):
    """``resnet50(num_classes=1000)`` with ``_resnet_state``'s weights,
    channels_last."""
    import torch

    from paddle_tpu_torch.models import load_jax_state
    from paddle_tpu_torch.vision.models import resnet50

    model = resnet50(num_classes=1000, device=dev)
    load_jax_state(model, _resnet_state(model, seed))
    return model.to(memory_format=torch.channels_last)


def phase_resnet_train(dev, smi, model, x1, y1, steps=10):
    """ResNet-50 training at the bench's size (``model`` from
    ``_resnet50``, the batch from ``_resnet_batch``): one warm-up step,
    then ``steps`` steps through ``run_steps`` over a ``[steps, B, ...]``
    stack of the one batch (as the bench broadcasts it), bf16 compute over
    f32 masters, channels_last, cuDNN autotuning on; then one profiled
    step."""
    import numpy as np
    import torch

    from paddle_tpu_torch.vision.models import resnet_conv_flops

    batch, size = x1.shape[0], x1.shape[-1]
    flops_fwd = resnet_conv_flops(model, size, size)
    step = _resnet_step(model, torch.bfloat16)
    xs, ys = (t.expand(steps, *t.shape) for t in (x1, y1))
    stats0 = {n: b.detach().clone() for n, b in model.named_buffers()}
    bench0 = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _conv_bn_counters(zero=True)
        with _no_plain():
            losses = [float(step(x1, y1))]                    # warm-up
            t0 = time.perf_counter()
            out = step.run_steps(xs, ys)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        n = _conv_bn_counters()
        peak = torch.cuda.max_memory_allocated()
        losses += out.tolist()
        prof = _device_profile(lambda: step(x1, y1))
    finally:
        torch.backends.cudnn.benchmark = bench0
    moved = min(float((b - stats0[k]).abs().max())
                for k, b in model.named_buffers())
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        _fail(f"resnet50 train: losses {losses} are not finite and falling")
    if step.compile_count != 1:
        _fail(f"resnet50 train: {step.compile_count} step builds for one "
              f"signature")
    if not moved > 0:
        _fail("resnet50 train: a batch-norm running statistic did not move")
    if any(n.values()):
        _fail(f"resnet50 train: conv+BN kernels launched on the model's path "
              f"{n} (the model convolves through F.conv2d)")
    ips = steps * batch / wall
    share = ips * 3 * flops_fwd / BF16_PEAK
    prof["by_kind_ms"] = _kernel_kinds(prof.pop("all_kernels_ms"))
    res = dict(batch=batch, size=size, steps=steps, losses=losses,
               step_ms=1e3 * wall / steps, images_per_s=ips,
               flops_fwd_per_image=flops_fwd, flops_share=share,
               peak_memory_bytes=peak, memory_format="channels_last",
               cudnn_benchmark=True, min_running_stat_move=moved,
               profile=prof)
    print(f"[resnet-train] resnet50 B={batch} {size}x{size} bf16 Momentum "
          f"(0.1, 0.9, L2 1e-4), channels_last, cudnn.benchmark on, TF32 "
          f"off: losses {', '.join(f'{v:.6f}' for v in losses)}")
    print(f"[resnet-train] {res['step_ms']:.3f} ms a step, {ips:.1f} "
          f"images/s, flops share {100 * share:.2f}% of the 989 TFLOP/s "
          f"dense bf16 peak ({flops_fwd / 1e9:.4f} GFLOP an image forward "
          f"from the model's conv and fc shapes, x3), peak memory {peak} "
          f"bytes, smallest running-stat move {moved:.3e}, on {smi}")
    _print_profile("resnet-train-profile", "one step", prof)
    print(f"[resnet-train-profile] device ms by kind: "
          f"{ {k: round(v, 3) for k, v in prof['by_kind_ms'].items()} }")
    del step, xs, ys
    return res


def phase_resnet_parity(dev, seed, tol=1e-4, stat_tol=1e-3):
    """``ResNet(depth=50)`` at batch 4 x 64^2, f32: three Momentum steps
    (a batch each) on the card and on the CPU from the same weights.
    Losses within ``tol`` relative; running statistics within
    ``stat_tol`` (abs + rel):
    layer4's batch norms see 16 values a channel, which magnifies the two
    devices' summation-order noise (2.3e-4 between the port and the JAX
    package on the CPU at resnet18)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models import load_jax_state, to_jax_state
    from paddle_tpu_torch.vision.models import ResNet

    out = []
    t0 = time.perf_counter()
    state = None
    for where in (dev, torch.device("cpu")):
        model = ResNet(depth=50, num_classes=1000, device=where)
        state = state or _resnet_state(model, seed + 1)
        load_jax_state(model, state)
        step = _resnet_step(model)
        losses = []
        for i in range(3):
            x, y = _resnet_batch(where, seed + 10 + i, 4, 64, False)
            losses.append(float(step(x, y)))
        out.append((np.array(losses), {
            k: v for k, v in to_jax_state(model).items()
            if k.endswith(("_mean", "_variance"))}))
    (card, sc), (cpu, sp) = out
    rel = float(np.max(np.abs(card - cpu) / np.abs(cpu)))
    stat_err = max(float(np.max(np.abs(sc[k] - sp[k])
                                / (1 + np.abs(sp[k])))) for k in sp)
    print(f"[resnet-parity] ResNet(depth=50) B=4 64x64 f32: card "
          f"{card.tolist()}, cpu {cpu.tolist()}, max rel diff {rel:.3e} (tol "
          f"{tol}); running statistics max |diff| / (1 + |cpu|) "
          f"{stat_err:.3e} (tol {stat_tol}); "
          f"{time.perf_counter() - t0:.1f} s")
    if not rel <= tol:
        _fail(f"resnet-parity: card and CPU losses differ by {rel} > {tol}")
    if not stat_err <= stat_tol:
        _fail(f"resnet-parity: running statistics differ by {stat_err} > "
              f"{stat_tol}")
    return dict(card=card.tolist(), cpu=cpu.tolist(), max_rel_diff=rel,
                tol=tol, stat_err=stat_err, stat_tol=stat_tol)


# kernels 11-13 against the model's own conv outputs: y within
# ACT_Y_TOL x max|y| and the statistics within ACT_STAT_TOL (mean: of the
# model's batch std; variance: relative).  The model applies each batch
# norm in bf16 (scale and shift rounded to bf16, x * scale + shift in
# bf16), the kernels in f32 rounded once: their conv inputs differ by up
# to a bf16 step in some elements, and the model's statistics come from
# its rounded output.
ACT_Y_TOL = 3e-2
ACT_STAT_TOL = 2e-2


def _bn_fold(z, values, name, eps=EPS):
    """The batch scale and shift (f32) that ``F.batch_norm`` folds in
    training for a bf16 input ``z`` and the bf16 parameters ``values``
    of batch norm ``name``, and the batch mean and variance."""
    import torch

    zf = z.float()
    mean = zf.mean(dim=(0, 2, 3))
    var = torch.clamp((zf * zf).mean(dim=(0, 2, 3)) - mean * mean, min=0)
    scale = torch.rsqrt(var + eps) * values[f"{name}.weight"].float()
    shift = -mean * scale + values[f"{name}.bias"].float()
    return scale.contiguous(), shift.contiguous(), mean, var


def _rows(z):
    """An NCHW (channels_last) activation as NHWC rows ``[n H W, C]``."""
    return z.permute(0, 2, 3, 1).contiguous().reshape(-1, z.shape[1])


def _act_check(what, y, st, want, mean, var, M):
    """Kernel output ``[M, N]`` and statistics against the model's."""
    import torch

    err_y = float((y.float() - want.float()).abs().max())
    lim_y = ACT_Y_TOL * float(want.float().abs().max())
    res = dict(err_y=err_y, lim_y=lim_y)
    if st is not None:
        km = st[0] / M
        kv = torch.clamp(st[1] / M - km * km, min=0)
        res["err_mean"] = float(((km - mean).abs() / var.sqrt()).max())
        res["err_var"] = float(((kv - var).abs() / var).max())
    print(f"[conv-bn-model] {what}: max |y - model| {err_y:.4e} (limit "
          f"{lim_y:.4e})" + ("" if st is None else
                             f", mean err {res['err_mean']:.3e} of the "
                             f"batch std, var err {res['err_var']:.3e} "
                             f"relative (limit {ACT_STAT_TOL})"))
    if not err_y <= lim_y:
        _fail(f"conv-bn-model {what}: y differs by {err_y} > {lim_y}")
    if st is not None and not max(res["err_mean"],
                                  res["err_var"]) <= ACT_STAT_TOL:
        _fail(f"conv-bn-model {what}: statistics differ {res}")
    return res


def phase_conv_bn_model(model, x):
    """Kernels 11-13 on the bottleneck activations of ResNet-50: one bf16
    training-mode forward of phase 19's batch ``x`` without gradients, on
    phase 19's ``model`` before it trains (its running statistics are left
    as they were), hooks on ``layer1[1]`` and ``layer3[1]`` (stride-1
    bottlenecks).  Kernel 12 takes conv1's raw output with bn1's
    batch scale and shift and conv2's weight, against conv2's output and
    bn2's statistics; kernel 11 (and ``run_pro``) conv2's raw output with
    bn2's, against conv3's output and bn3's statistics; ``run_mm`` the
    model's own conv3 input, against conv3's output at the bf16 tolerance
    (the same operands).  Counters set to 0 just before, read just after;
    the plain versions are tripped."""
    import torch

    from paddle_tpu_torch.kernels import conv_bn as cb

    blocks = {"layer1[1]": model.layer1[1], "layer3[1]": model.layer3[1]}
    seen = {}
    hooks = []
    for tag, blk in blocks.items():
        for name in ("conv1", "conv2", "conv3"):
            def hook(mod, inp, out, tag=tag, name=name):
                seen[(tag, name)] = (inp[0], out)
            hooks.append(getattr(blk, name).register_forward_hook(hook))
    values = {n: p.to(torch.bfloat16) for n, p in model.named_parameters()}
    # the forward updates copies of the running statistics, not the model's
    scratch = {n: b.clone() for n, b in model.named_buffers()}
    with torch.no_grad():
        torch.func.functional_call(model, {**values, **scratch},
                                   (x.to(torch.bfloat16),))
    for h in hooks:
        h.remove()
    rows = {}
    passes = 0                          # prologue passes the plans take
    _conv_bn_counters(zero=True)
    with torch.no_grad(), _no_plain():
        for tag in blocks:
            _, z1 = seen[(tag, "conv1")]
            _, z2 = seen[(tag, "conv2")]
            a3, z3 = seen[(tag, "conv3")]
            n, C, H, W = z1.shape
            M = n * H * W
            pre = tag.replace("[", ".").replace("]", "")
            s1, b1, _, _ = _bn_fold(z1, values, f"{pre}.bn1")
            s2, b2, m2, v2 = _bn_fold(z2, values, f"{pre}.bn2")
            _, _, m3, v3 = _bn_fold(z3, values, f"{pre}.bn3")
            w2 = values[f"{pre}.conv2.weight"].permute(2, 3, 1,
                                                       0).contiguous()
            w3 = values[f"{pre}.conv3.weight"]
            w3 = w3.reshape(w3.shape[0], -1).t().contiguous()
            z1n = z1.permute(0, 2, 3, 1).contiguous()
            r2, r3, ra3 = _rows(z2), _rows(z3), _rows(a3)
            sms = cb._sms(z1.device)
            passes += sum(cb.conv_plan(*shape, sms=sms)["prologue"] == "pass"
                          for shape in ((M, w2.shape[3], C),
                                        (M, w3.shape[1]), (M, w3.shape[1])))
            y12, st12 = cb.fused3x3(z1n, s1, b1, w2)
            rows[f"{tag} fused3x3"] = _act_check(
                f"{tag} fused3x3 {n}x{H}x{W} C={C}->{w2.shape[3]}",
                y12.reshape(M, -1), st12, r2, m2, v2, M)
            y11, st11 = cb.fused_conv1x1_bn(r2, s2, b2, w3)
            rows[f"{tag} fused_conv1x1_bn"] = _act_check(
                f"{tag} fused_conv1x1_bn M={M} K={w3.shape[0]} "
                f"N={w3.shape[1]}", y11, st11, r3, m3, v3, M)
            rows[f"{tag} run_pro"] = _act_check(
                f"{tag} run_pro", cb.run_pro(r2, s2, b2, w3, bm=128), None,
                r3, None, None, M)
            ymm = cb.run_mm(ra3, w3, bm=128)
            err = _max_err([ymm], [r3], torch.bfloat16,
                           f"conv-bn-model {tag} run_mm")
            ys, sts = cb.run_mm(ra3, w3, bm=128, kern=cb._k_stat, nstat=True)
            rows[f"{tag} run_mm"] = dict(_act_check(
                f"{tag} run_mm (the model's conv3 input; bf16 tolerance "
                f"held above, max err {err:.3e})", ys, sts, r3, m3, v3, M),
                err_y_bf16=err)
    torch.cuda.synchronize()
    n = _conv_bn_counters()
    want = {"fused_conv1x1_bn": 2, "fused3x3": 2, "run_mm": 4,
            "run_mm _k_mm": 2, "run_mm _k_stat": 2, "run_pro": 2,
            "conv_bn_column_sum": 6, "fused_conv1x1_bn wgmma": 2,
            "fused3x3 wgmma": 2, "fused3x3 mma": 0, "run_mm wgmma": 4,
            "run_pro wgmma": 2, "conv_bn_prologue": passes}
    if n != want:
        _fail(f"conv-bn-model: launches {n} != {want}")
    print(f"[conv-bn-model] launches {n}")
    del values, scratch, seen
    return dict(rows=rows, launches=n)


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
    build_s, sass = phase_build()
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
    dead = phase_dead_rows(dev)
    att = phase_attention_train(dev)
    train = phase_train(dev, args.seed, smi)
    torch.cuda.empty_cache()
    parity = phase_train_parity(dev, args.seed)
    # the fused-LayerNorm phases come last, for the same reason
    torch.cuda.empty_cache()
    ln_rows = phase_layernorm(dev)
    lnmm_rows = phase_ln_matmul(dev, sass)
    fused = phase_fused_train(dev, args.seed, smi, train["losses"])
    torch.cuda.empty_cache()
    parity_ln = phase_train_parity(dev, args.seed, fused_ln=True)
    serve_ln = phase_serve(dev, None, 8, 16, args.seed + 2, 1e-3,
                           ln_mode="full")
    # the ResNet slice's phases follow the earlier ones, for the same reason
    torch.cuda.empty_cache()
    conv_rows = phase_conv_bn(dev)
    # phase 21 runs on phase 19's model and batch before it trains
    model = _resnet50(dev, args.seed)
    x1, y1 = _resnet_batch(dev, args.seed, 128, 224, True)
    conv_model = phase_conv_bn_model(model, x1)
    torch.cuda.empty_cache()
    resnet = phase_resnet_train(dev, smi, model, x1, y1)
    del model, x1, y1
    torch.cuda.empty_cache()
    resnet_parity = phase_resnet_parity(dev, args.seed)
    # the paged read in the serving profile's window: its kernels' launches
    # and device ms a call (None where the profiler saw no device time)
    prof = serve["profile"]

    def per_call(x):
        if not prof["paged_calls"] or prof["device_busy_share"] is None:
            return None
        return x / prof["paged_calls"]

    print(f"[paged] serving window: {prof['paged_calls']} calls, "
          f"{prof['paged_kernel_launches']} paged kernel launches, "
          f"{prof['paged_ms']:.3f} ms of paged kernels")

    f_main = next(r for r in flash if r["Tq"] == 128 and r["causal"]
                  and r["dtype"] == "float32")
    p_main = next(r for r in paged if r["case"] == "serve W=1 f32")
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
                    eager_ms=row["eager_ms"] if part is None else None,
                    plain_ms=row["plain_ms"], bound_ms=bound[0],
                    bound_by=bound[1], library_ms=row["library_ms"],
                    library_bwd_ms=row["library_bwd_ms"],
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
             ms=f_main["ms"], eager_ms=f_main["eager_ms"],
             plain_ms=f_main["plain_ms"],
             bound_ms=f_main["bound_ms"], bound_by=f_main["bound_by"],
             library_ms=f_main["library_ms"],
             shape="B=4 T=128 H=12 D=64 causal"),
        dict(name="flash_attention_qkv_fused", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/flash_attention_fwd.cu",
             replaces=f"{fa_py}:490", launches=n_tr["fused_fwd"],
             max_abs_err=fused_fwd["max_abs_err"], ms=fused_fwd["ms"],
             eager_ms=fused_fwd["eager_ms"],
             plain_ms=fused_fwd["plain_ms"], bound_ms=fused_fwd["bound_ms"],
             bound_by=fused_fwd["bound_by"],
             library_ms=fused_fwd["library_ms"],
             shape="B=16 T=1024 H=12 D=64 bfloat16 causal"),
        bwd_row("flash_attention_qkv_fused_bwd (delta + dk/dv + dq kernels)",
                534, n_tr["fused_bwd_delta"] + n_tr["fused_bwd_dkv"]
                + n_tr["fused_bwd_dq"], fused_bwd),
        bwd_row("flash_attention_bwd (delta + dk/dv + dq kernels)", 371,
                n_att[1024]["bwd_delta"] + n_att[1024]["bwd_dkv"]
                + n_att[1024]["bwd_dq"], sep_1024),
        bwd_row("flash_bwd_dq_kernel", 402, n_att[1100]["bwd_dq"], sep_1100,
                "dq"),
        bwd_row("flash_bwd_dkv_kernel", 425, n_att[1100]["bwd_dkv"],
                sep_1100, "dkv"),
        dict(name="paged_decode_attention", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/paged_attention.cu",
             replaces="paddle_tpu/kernels/paged_attention.py:281",
             launches=serve["paged_launches"],
             max_abs_err=max(r["max_abs_err"] for r in paged),
             ms=p_main["ms"], eager_ms=p_main["eager_ms"],
             device_ms=per_call(prof["paged_ms"]),
             kernel_launches_per_call=per_call(
                 prof["paged_kernel_launches"]),
             plain_ms=p_main["plain_ms"],
             bound_ms=p_main["bound_ms"], bound_by=p_main["bound_by"],
             library_ms=p_main["library_ms"],
             library="gather + scaled_dot_product_attention (two calls, "
                     "no one-call equivalent)",
             sass_async_copy={k: dict(UTMALDG=v[1], UBLKCP=v[2])
                              for k, v in (sass or {}).items()
                              if k.startswith("paged_")},
             shape="B=9 W=1 H=12 D=64 P=16 n_pt=40 f32",
             per_call_of="device_ms and kernel_launches_per_call: the "
                         "serving profile's window, per paged call"),
    ]
    n_ln = fused["both"]["launches"]
    qkv = next(r for r in lnmm_rows if r["M"] == 2304 and r["N"] == 16384)
    kernels.append(dict(
        name="ln_matmul (statistics + wgmma kernels)", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/ln_matmul.cu",
        replaces="paddle_tpu/kernels/ln_matmul.py:100",
        launches=n_ln["ln_matmul"],
        max_abs_err=max(r["max_abs_err"] for r in lnmm_rows),
        ms=qkv["ms"], plain_ms=qkv["plain_ms"], bound_ms=qkv["bound_ms"],
        bound_by=qkv["bound_by"], library_ms=qkv["library_ms"],
        tflops=qkv["tflops"], sass_hgmma_utmaldg=qkv["sass"],
        shape="N=16384 K=768 M=2304 bfloat16 (qkv)"))
    ln_src = "paddle_tpu_torch/kernels/csrc/layer_norm.cu"
    for part, line, launches, title in (
            ("fwd", 115, n_ln["ln_fwd"], "layer_norm_fwd"),
            ("bwd", 152, n_ln["ln_bwd"] + n_ln["ln_bwd_reduce"],
             "layer_norm_bwd (dx + column-sum kernels)")):
        main_row = next(r for r in ln_rows if r["part"] == part
                        and r["N"] == 16384 and r["dtype"] == "bfloat16"
                        and r["dy_dtype"] == "bfloat16")
        kernels.append(dict(
            name=title, route="cuda", source=ln_src,
            replaces=f"paddle_tpu/kernels/layer_norm.py:{line}",
            launches=launches,
            max_abs_err=max(r["max_abs_err"] for r in ln_rows
                            if r["part"] == part),
            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"],
            shape="N=16384 C=768 bfloat16"))
    n_cb = conv_model["launches"]
    cb_src = "paddle_tpu_torch/kernels/csrc/conv_wgmma.cuh"
    for title, replaces, launches, pick in (
            ("fused_conv1x1_bn (conv1x1_wgmma + column-sum kernels)",
             "tools/exp_conv_bn.py:63", n_cb["fused_conv1x1_bn"],
             lambda r: r["kernel"] == "full" and r["M"] == 200704
             and r["K"] == 64),
            ("fused3x3 (prologue pass + conv3x3_wgmma + column-sum kernels)",
             "tools/exp_conv3x3.py:62", n_cb["fused3x3"],
             lambda r: r["kernel"] == "3x3" and r["H"] == 56),
            ("run_mm, body _k_mm (conv1x1_wgmma)", "tools/exp_conv_bn2.py:67",
             n_cb["run_mm _k_mm"],
             lambda r: r["kernel"] == "mm" and r["M"] == 50176),
            ("run_mm, body _k_stat (conv1x1_wgmma + column-sum kernels)",
             "tools/exp_conv_bn2.py:67", n_cb["run_mm _k_stat"],
             lambda r: r["kernel"] == "stat" and r["M"] == 50176),
            ("run_pro, body _k_pro (conv1x1_wgmma)",
             "tools/exp_conv_bn2.py:85", n_cb["run_pro"],
             lambda r: r["kernel"] == "pro" and r["M"] == 50176)):
        row = next(r for r in conv_rows if pick(r))
        same = [r for r in conv_rows if r["kernel"] == row["kernel"]]
        # the statistics' error (f32 column sums) apart from y's (bf16),
        # from the case nearest its tolerance
        worst = max(same, key=lambda r: (r["stats_abs_err"] or 0.0)
                    / (r["stats_tol"] or 1.0))
        kernels.append(dict(
            name=title, route="cuda", source=cb_src, replaces=replaces,
            launches=launches,
            max_abs_err=max(r["max_abs_err"] for r in same),
            stats_abs_err=worst["stats_abs_err"],
            stats_tol=worst["stats_tol"],
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            chain_ms=row["chain_ms"], shape=row["shape"] + " bfloat16",
            column_sum_launches=n_cb["conv_bn_column_sum"],
            prologue_pass_launches=n_cb["conv_bn_prologue"],
            kernel_route=row["route"], tile=row["tile"],
            sass_hgmma_utmaldg={
                k: v[:2] for k, v in (sass or {}).items()
                if k.startswith("conv_wgmma_kernel<"
                                + ("1" if row["kernel"] == "3x3" else "0"))}))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(dict(device=smi, torch_device=name, count=count,
                           build_s=build_s, sass=sass, flash=flash,
                           paged=paged,
                           flash_bwd=bwd, dead_rows=dead,
                           fused_fwd=fused_fwd,
                           fused_bwd=fused_bwd, serve=[serve, serve8],
                           attention_train=att, train=train,
                           parity=parity, layernorm=ln_rows,
                           ln_matmul=lnmm_rows, fused_train=fused,
                           parity_ln=parity_ln, serve_ln=serve_ln,
                           conv_bn=conv_rows, resnet_train=resnet,
                           resnet_parity=resnet_parity,
                           conv_bn_model=conv_model, kernels=kernels,
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
