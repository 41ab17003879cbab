"""A/B of the flash-attention kernels and the GPT training cell, the
fused-LayerNorm cell, the conv+BN kernels, the paged decode kernel, the
serving cell, the CRNN cell or the fit loop, between checkouts of the
PyTorch/CUDA port, on one card, in turns.

Usage, from the root of a checkout, with one CUDA card::

    git archive <parent> | tar -x -C build/parent
    python tools/flash_ab.py --roots build/parent . . build/parent \\
        --out build/flash_ab.json [--mode fused-ln | conv-bn | paged |
        serve | crnn | fit]

Each root runs in a fresh process that imports ``paddle_tpu_torch`` from
that root (and builds its kernels there).  ``--mode flash`` (the default)
measures, at the training shape B=16 T=1024 H=12 D=64 bf16 causal:

* the fused forward (``flash_attention_qkv_fused``) and the fused backward
  (``flash_attention_qkv_fused_bwd``: every kernel and torch op it runs,
  delta included): device ms from CUDA-graph replays, the eager call's ms,
  and the backward's ms by kernel from ``torch.profiler``;
* the training cell of ``chip_smoke.py`` phase 11 (gpt2-small-en at full
  width, batch 16 x 1024, bf16 over f32 masters, AdamW; the same random
  weights and batch): one warm-up and 5 timed steps (step ms, tokens/s,
  flops share of the 989 TFLOP/s dense bf16 peak), then one profiled step
  (the attention kernels' ms: kernel names holding ``flash_``; the
  device's busy share).

``--mode fused-ln`` measures the same cell with both fused-LayerNorm
toggles on (``enable_ln_matmul(True)``, ``enable_fused_layernorm("full")``:
``chip_smoke.py`` phase 15's both-on step) and, beside it, unfused: step
ms, tokens/s and flops share of each, and from one profiled both-on step
the ``ln_matmul`` kernels' ms (names holding ``ln_matmul`` or
``ln_stats``), the LayerNorm kernels' ms (``ln_fwd``, ``ln_bwd``,
``colsum2``), the busy share and the step's kernels by device time.

``--mode conv-bn`` measures the conv+BN kernels (rows 11-13) at every
case of ``chip_smoke.py`` phase 18: the 8 1x1 shapes (``fused_conv1x1_bn``),
the 3 split shapes in their four variants (``run_mm`` ``_k_mm`` and
``_k_stat``, ``run_pro``, ``fused_conv1x1_bn``), the ragged M and the 5
3x3 cases (``fused3x3``): each case's device ms from CUDA-graph replays
over the phase's rotating input sets (the same seed), through the public
entry points only, so any two checkouts compare.

``--mode paged`` measures the paged decode kernel (row 7) at every case
of ``chip_smoke.py``'s ``PAGED_CASES`` (the same seeds): device ms from
CUDA-graph replays over the phase's rotating pool sets, the eager call's
ms (back-to-back calls: the host's time where the host is the slower
side), the host's µs a call (``_host_us``: issuing calls between two
syncs, so the device's time does not enter) and of that the wrapper's
Python alone (``python_us``: the C entry point stubbed out, so the rest
is the C side's launches), through the public entry point only, after
one call is held against the plain version at 1e-4.  A case the root's kernel refuses
(``ValueError``) reads null.

``--mode serve`` runs ``chip_smoke.py`` phase 4's serving cell (f32
pools, 24 requests of 32 new tokens on full-width gpt2-small-en, the
teacher-forced check included) and its profiled window of 8 requests:
tokens/s, p50 time to first token, the host's ms per decode step, the
device ms per replayed decode step (CUDA events around each replay of
the decode graph; null for a checkout whose engine has no graph), and
from the window the paged kernels' device ms and the device's busy
share.

``--mode crnn`` runs ``chip_smoke.py`` phase 36's CRNN training cell (f32,
batch 128, the LSTM through torch's fused recurrent op) three times in
the root's process: each run's step ms, and their median as
``step_ms`` (the step is short and host-bound).

``--mode fit`` runs ``chip_smoke.py`` phase 42, the paddle user's
training loop (``DataLoader`` workers over the shm ring, ``Model.fit``
with ``prefetch=True``, checkpoints, a SIGTERM and ``resume="auto"`` at
BERT-base width, 64 x 512 bf16) with all its gates: the fit loop's
device ms a step (CUDA events at each batch's begin: the mean of the
uninterrupted run's warm steps, its saves included, as ``fit_step_ms``,
their median, and the mean of the checkpoint-free run D's warm steps as
``nosave_step_ms``), the busy share of D's warm steps under the
profiler, the prefetcher's wait and stalls, the emergency save's and the
restore's ms.  A checkout without ``paddle_tpu_torch.Model`` (before the
fit loop was ported) reads null.

The helpers come from this checkout's ``chip_smoke.py``.  Prints one JSON
line a run, the ``nvidia-smi`` name and power limit, and the mean of each
root's runs with the ratio of the first root's to every other's.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, H, D = 16, 1024, 12, 64
KEYS = {"flash": ("fwd_ms", "fwd_eager_ms", "bwd_ms", "bwd_eager_ms",
                  "step_ms", "tokens_per_s", "flops_share", "attention_ms",
                  "busy_share"),
        "fused-ln": ("step_ms", "tokens_per_s", "flops_share",
                     "unfused_step_ms", "ln_matmul_ms", "ln_kernels_ms",
                     "busy_share"),
        "conv-bn": None,          # the case names, from the run
        "paged": None,
        "serve": ("tokens_per_s", "p50_ttft_ms", "decode_step_ms",
                  "device_step_ms", "window_paged_ms",
                  "window_decode_steps", "window_busy_share"),
        "crnn": ("step_ms", "run_1_ms", "run_2_ms", "run_3_ms"),
        "fit": ("fit_step_ms", "fit_median_ms", "nosave_step_ms",
                "busy_share", "wait_ms",
                "stalls", "emergency_save_ms", "restore_ms")}


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(root: str, steps: int = 5, seed: int = 0) -> dict:
    """The numbers of one root, in this process (``root`` first on the
    path)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    cs = _smoke()
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import gpt_train_flops_per_token

    if not torch.cuda.is_available():
        raise SystemExit("flash_ab: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    res = dict(root=root, package=os.path.dirname(fa.__file__))
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(B, T, H, 3, D, device=dev, generator=gen).to(
        torch.bfloat16)
    do = torch.randn(B, T, H * D, device=dev, generator=gen).to(
        torch.bfloat16)
    out, lse = fa._fused_fwd(qkv, True, D ** -0.5)

    def fwd():
        return fa.flash_attention_qkv_fused(qkv)

    def bwd():
        return fa.flash_attention_qkv_fused_bwd(qkv, out, lse, do, True)

    if not bool(torch.isfinite(bwd().float()).all()):
        raise SystemExit(f"flash_ab: non-finite gradients from {root}")
    res["fwd_ms"], res["fwd_eager_ms"] = cs._graph_ms(fwd, 20), \
        cs._timed_ms(fwd, 20)
    res["bwd_ms"], res["bwd_eager_ms"] = cs._graph_ms(bwd, 10), \
        cs._timed_ms(bwd, 10)
    prof = cs._device_profile(lambda: [bwd() for _ in range(3)])
    res["bwd_kernels_ms"] = {k[:80]: v / 3 for k, v in
                             prof["all_kernels_ms"].items()}
    del out, lse, do, qkv
    torch.cuda.empty_cache()

    model = cs._train_model(dev, seed)
    step = cs._train_step(model, torch.bfloat16)
    x, y = cs._train_batch(dev, seed, B, T, model.config.vocab_size)
    losses = [float(step(x, y))]
    t0 = time.perf_counter()
    outs = [step(x, y) for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses += [float(v) for v in outs]
    res["losses"] = losses
    res["step_ms"] = 1e3 * wall / steps
    res["tokens_per_s"] = steps * B * T / wall
    res["flops_share"] = (res["tokens_per_s"] * gpt_train_flops_per_token(
        model.config, T) / cs.BF16_PEAK)
    prof = cs._device_profile(lambda: step(x, y))
    res["attention_ms"] = sum(v for k, v in prof["all_kernels_ms"].items()
                              if "flash_" in k)
    res["busy_share"] = prof["device_busy_share"]
    res["step_profile_window_ms"] = prof["window_ms"]
    return res


def _steps(cs, step, x, y, steps):
    """One warm-up and ``steps`` timed steps: (losses, step ms)."""
    import torch

    losses = [float(step(x, y))]
    t0 = time.perf_counter()
    outs = [step(x, y) for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return losses + [float(v) for v in outs], 1e3 * wall / steps


def measure_fused_ln(root: str, steps: int = 5, seed: int = 0) -> dict:
    """The both-on training cell and the unfused one of one root, in this
    process (``root`` first on the path)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    cs = _smoke()
    from paddle_tpu_torch.kernels import ln_matmul as lnmm
    from paddle_tpu_torch.models import gpt_train_flops_per_token

    if not torch.cuda.is_available():
        raise SystemExit("flash_ab: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    res = dict(root=root, package=os.path.dirname(lnmm.__file__))
    model = cs._train_model(dev, seed)
    step = cs._train_step(model, torch.bfloat16)
    x, y = cs._train_batch(dev, seed, B, T, model.config.vocab_size)
    flops = gpt_train_flops_per_token(model.config, T)
    with cs._toggles("full", True):
        res["losses"], res["step_ms"] = _steps(cs, step, x, y, steps)
        prof = cs._device_profile(lambda: step(x, y))
    res["unfused_losses"], res["unfused_step_ms"] = _steps(cs, step, x, y,
                                                           steps)
    res["tokens_per_s"] = B * T / res["step_ms"] * 1e3
    res["flops_share"] = res["tokens_per_s"] * flops / cs.BF16_PEAK
    kernels = prof["all_kernels_ms"]
    res["ln_matmul_ms"] = sum(v for k, v in kernels.items()
                              if "ln_matmul" in k or "ln_stats" in k)
    res["ln_kernels_ms"] = sum(v for k, v in kernels.items()
                               if "ln_fwd" in k or "ln_bwd" in k
                               or "colsum2" in k)
    res["busy_share"] = prof["device_busy_share"]
    res["step_profile_window_ms"] = prof["window_ms"]
    res["top_kernels_ms"] = {k[:80]: v for k, v in
                             list(kernels.items())[:25]}
    return res


def measure_conv_bn(root: str, seed: int = 18) -> dict:
    """Device ms of every phase-18 conv+BN case of one root, in this
    process (``root`` first on the path)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    cs = _smoke()
    from paddle_tpu_torch.kernels import conv_bn as cb

    if not torch.cuda.is_available():
        raise SystemExit("flash_ab: no CUDA card")
    dev = torch.device("cuda", 0)
    res = dict(root=root, package=os.path.dirname(cb.__file__))
    gen = torch.Generator(device=dev).manual_seed(seed)
    calls = {
        "full": lambda x, s, b, w: cb.fused_conv1x1_bn(x, s, b, w),
        "pro": lambda x, s, b, w: cb.run_pro(x, s, b, w),
        "stat": lambda x, s, b, w: cb.run_mm(x, w, kern=cb._k_stat,
                                              nstat=True),
        "mm": lambda x, s, b, w: cb.run_mm(x, w)}
    cases = ([(shape, ("full",)) for shape in cs.CONV1X1_SHAPES]
             + [(shape, ("mm", "stat", "pro", "full"))
                for shape in cs.SPLIT_SHAPES]
             + [((12345, 256, 64), ("full",))])
    for (M, K, N), tags in cases:
        _, nbytes = cb.conv1x1_cost(M, K, N)
        sets = [cs._conv_inputs(gen, dev, (M, K), K, (K, N), K)
                for _ in range(cs._n_sets(nbytes))]
        for tag in tags:
            res[f"{tag} M={M} K={K} N={N}"] = cs._graph_ms(
                cs._rotating(calls[tag], sets), 10)
        del sets
        torch.cuda.empty_cache()
    for (n, H, W, C, Co), b_pos in ([(s, False) for s in cs.CONV3X3_SHAPES]
                                    + [((8, 14, 14, 256, 256), True)]):
        _, nbytes = cb.conv3x3_cost(n, H, W, C, Co)
        sets = [cs._conv_inputs(gen, dev, (n, H, W, C), C, (3, 3, C, Co),
                                9 * C, b_pos)
                for _ in range(cs._n_sets(nbytes))]
        name = f"3x3 n={n} {H}x{W} C={C}->{Co}{' b>0' if b_pos else ''}"
        res[name] = cs._graph_ms(cs._rotating(cb.fused3x3, sets), 10)
        del sets
        torch.cuda.empty_cache()
    return res


class _StubLibrary:
    """A kernel library whose paged entry point launches nothing."""

    @staticmethod
    def paddle_paged_decode_attention(*args):
        return 0


def _host_us(call, calls=64, reps=5):
    """The host's µs a call: the wall time of issuing ``calls`` calls
    after a sync and before the next (too few to fill the launch queue,
    so the device's time does not enter), the median of ``reps``."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        times.append(1e6 * (time.perf_counter() - t0) / calls)
    torch.cuda.synchronize()
    return sorted(times)[reps // 2]


def measure_paged(root: str) -> dict:
    """Device and eager ms of the paged kernel at every ``PAGED_CASES``
    case of one root, in this process (``root`` first on the path)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    cs = _smoke()
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import paged_attention as pa

    if not torch.cuda.is_available():
        raise SystemExit("flash_ab: no CUDA card")
    dev = torch.device("cuda", 0)
    res = dict(root=root, package=os.path.dirname(pa.__file__))
    for case in cs.PAGED_CASES:
        name = case[0]
        _, sets = cs._paged_inputs(dev, case, cs._paged_n_sets(case))
        try:
            out = pa.paged_decode_attention(*sets[0])
        except ValueError as e:
            print(f"flash_ab: {root} refuses {name}: {e}", file=sys.stderr)
            res[f"{name} ms"] = res[f"{name} eager_ms"] = None
            res[f"{name} host_us"] = res[f"{name} python_us"] = None
            continue
        live = sets[0][4] < case[3] * cs.PAGED_P
        err = float((out[live] - pa.paged_decode_attention_plain(
            *sets[0])[live]).abs().max())
        if not err <= 1e-4:
            raise SystemExit(f"flash_ab: {root} {name}: max abs err {err}")
        call = cs._rotating(pa.paged_decode_attention, sets)
        res[f"{name} ms"] = cs._graph_ms(call, 10)
        res[f"{name} eager_ms"] = cs._timed_ms(call, 96)
        res[f"{name} host_us"] = _host_us(call)
        # the wrapper's Python alone: the C entry point stubbed out
        real = _build.library
        _build.library = lambda: _StubLibrary()
        try:
            res[f"{name} python_us"] = _host_us(call)
        finally:
            _build.library = real
        del sets, out
        torch.cuda.empty_cache()
    return res


def measure_serve(root: str, seed: int = 0) -> dict:
    """Phase 4's serving cell of one root, in this process (``root``
    first on the path)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    cs = _smoke()
    from paddle_tpu_torch import serving

    if not torch.cuda.is_available():
        raise SystemExit("flash_ab: no CUDA card")
    out = cs.phase_serve(torch.device("cuda", 0), None, 24, 32, seed, 1e-3,
                         profile=True)
    prof = out["profile"]
    return dict(root=root, package=os.path.dirname(serving.__file__),
                tokens_per_s=out["tokens_per_s"],
                p50_ttft_ms=out["p50_ttft_ms"],
                decode_step_ms=out["decode_step_ms"],
                device_step_ms=out["device_step_ms"],
                window_paged_ms=prof["paged_ms"],
                window_decode_steps=prof["decode_steps"],
                window_busy_share=prof["device_busy_share"])


def measure_crnn(root: str, seed: int = 0, runs: int = 3) -> dict:
    """Phase 36's CRNN cell of one root, ``runs`` times in this process
    (``root`` first on the path)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    cs = _smoke()
    from paddle_tpu_torch import vision

    if not torch.cuda.is_available():
        raise SystemExit("flash_ab: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ms = [cs.phase_crnn(torch.device("cuda", 0), "", seed)["step_ms"]
          for _ in range(runs)]
    res = dict(root=root, package=os.path.dirname(vision.__file__),
               step_ms=sorted(ms)[len(ms) // 2])
    res.update({f"run_{i + 1}_ms": v for i, v in enumerate(ms)})
    return res


def measure_fit(root: str, seed: int = 16) -> dict:
    """Phase 42's fit loop of one root, in this process (``root`` first
    on the path); null for a root without the fit loop."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import paddle_tpu_torch

    cs = _smoke()
    if not torch.cuda.is_available():
        raise SystemExit("flash_ab: no CUDA card")
    res = dict(root=root, package=os.path.dirname(paddle_tpu_torch.__file__))
    if not hasattr(paddle_tpu_torch, "Model"):
        return dict(res, **{k: None for k in KEYS["fit"]})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = cs.phase_fit(torch.device("cuda", 0), seed, "")
    a, b, c = (out["runs"][k] for k in "ABC")
    return dict(res, fit_step_ms=out["fit_step_ms"],
                fit_median_ms=out["fit_median_ms"],
                nosave_step_ms=out["nosave_step_ms"],
                busy_share=out["profile"]["device_busy_share"],
                wait_ms=1e3 * a["prefetch"]["wait_seconds"],
                stalls=a["prefetch"]["stalls"],
                emergency_save_ms=b["snapshot_ms"][-1] + b["write_ms"][-1],
                restore_ms=c["load_ms"][0])


MEASURE = {"flash": measure, "fused-ln": measure_fused_ln,
           "conv-bn": measure_conv_bn, "paged": measure_paged,
           "serve": measure_serve, "crnn": measure_crnn, "fit": measure_fit}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", default=["."],
                    help="checkout roots, run in this order")
    ap.add_argument("--one", help="measure this root in this process")
    ap.add_argument("--mode", choices=sorted(KEYS), default="flash")
    ap.add_argument("--out", help="also write every run as JSON")
    args = ap.parse_args(argv)
    keys = KEYS[args.mode]
    if args.one:
        print(json.dumps(MEASURE[args.mode](args.one)))
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    runs = []
    for root in args.roots:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root,
             "--mode", args.mode],
            capture_output=True, text=True, timeout=900, cwd=HERE)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"flash_ab: the run of {root} failed")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(run)
        keys = keys or tuple(k for k in run if k not in ("root", "package"))
        print(json.dumps({k: run[k] for k in ("root", *keys)}))
    mean = {}
    for root in dict.fromkeys(args.roots):
        mine = [r for r in runs if r["root"] == root]
        mean[root] = {k: (None if any(r[k] is None for r in mine)
                          else sum(r[k] for r in mine) / len(mine))
                      for k in keys}
    first = args.roots[0]
    ratio = {root: {k: (None if None in (mean[first][k], mean[root][k])
                        else mean[first][k] / mean[root][k]) for k in keys}
             for root in mean if root != first}
    print(smi)
    print(json.dumps(dict(mean=mean, first_over=ratio)))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(dict(device=smi, runs=runs, mean=mean,
                           first_over=ratio), fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
