"""A/B of the flash-attention kernels and the GPT training cell between
checkouts of the PyTorch/CUDA port, on one card, in turns.

Usage, from the root of a checkout, with one CUDA card::

    git archive <parent> | tar -x -C build/parent
    python tools/flash_ab.py --roots build/parent . . build/parent \\
        --out build/flash_ab.json

Each root runs in a fresh process that imports ``paddle_tpu_torch`` from
that root (and builds its kernels there) and measures, at the training
shape B=16 T=1024 H=12 D=64 bf16 causal:

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
KEYS = ("fwd_ms", "fwd_eager_ms", "bwd_ms", "bwd_eager_ms", "step_ms",
        "tokens_per_s", "flops_share", "attention_ms", "busy_share")


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", default=["."],
                    help="checkout roots, run in this order")
    ap.add_argument("--one", help="measure this root in this process")
    ap.add_argument("--out", help="also write every run as JSON")
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(measure(args.one)))
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    runs = []
    for root in args.roots:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root],
            capture_output=True, text=True, timeout=900, cwd=HERE)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"flash_ab: the run of {root} failed")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(run)
        print(json.dumps({k: run[k] for k in ("root", *KEYS)}))
    mean = {}
    for root in dict.fromkeys(args.roots):
        mine = [r for r in runs if r["root"] == root]
        mean[root] = {k: sum(r[k] for r in mine) / len(mine) for k in KEYS}
    first = args.roots[0]
    ratio = {root: {k: mean[first][k] / mean[root][k] for k in KEYS}
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
