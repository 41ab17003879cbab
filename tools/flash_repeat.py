"""Run-to-run repeatability of the bf16 flash-attention kernels between
checkouts of the PyTorch/CUDA port, on one card: the fused forward (row
5) and the fused backward's delta, dk/dv and dq kernels (row 6) at the
GPT training shape B=16 T=1024 H=12 D=64, causal.

Usage, from the root of a checkout, with one CUDA card::

    git archive <parent> | tar -x -C build/parent
    python tools/flash_repeat.py --roots build/parent . --iters 20000 \\
        [--out build/flash_repeat.json]

Each root runs in a fresh process that imports ``paddle_tpu_torch`` from
that root (and builds its kernels there).  It launches the forward and
the backward ``--iters`` times on one set of inputs, every second time
beside a 1 GiB device copy on a second stream (memory traffic that moves
the kernels' tile loads in time), and counts per output (out, lse, dq,
dk, dv) the launches whose result differs bitwise from the first
launch's.  The kernels sum without atomics in a fixed order, so every
count should be 0.  Prints one JSON line a root and the ``nvidia-smi``
name and power limit; exits 1 if any count is not 0.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

B, T, H, D = 16, 1024, 12, 64
OUTPUTS = ("out", "lse", "dq", "dk", "dv")


def measure(root: str, iters: int, seed: int = 0) -> dict:
    """The mismatch counts of one root, in this process (``root`` first
    on the path)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("flash_repeat: no CUDA card")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(B, T, H, 3, D, device=dev, generator=gen).to(
        torch.bfloat16)
    do = torch.randn(B, T, H * D, device=dev, generator=gen).to(
        torch.bfloat16)
    scale = D ** -0.5
    out0, lse0 = fa._fused_fwd(qkv, True, scale)
    g0 = fa.flash_attention_qkv_fused_bwd(qkv, out0, lse0, do, scale=scale)
    src = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    main, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
    bad = torch.zeros(len(OUTPUTS), dtype=torch.int64, device=dev)
    counter = fa.flash_attention_qkv_fused_bwd
    before = counter.launches_dkv
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        if i % 2:
            side.wait_stream(main)       # starts beside this launch
            with torch.cuda.stream(side):
                dst.copy_(src)
        out, lse = fa._fused_fwd(qkv, True, scale)
        # the backward reads the first forward's out and lse, so its
        # count is its own
        g = fa.flash_attention_qkv_fused_bwd(qkv, out0, lse0, do,
                                             scale=scale)
        bad[0] += (out != out0).any()
        bad[1] += (lse != lse0).any()
        bad[2:] += (g != g0).reshape(-1, 3, D).any(-1).any(0)
    main.wait_stream(side)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if counter.launches_dkv - before != iters:
        raise SystemExit(f"flash_repeat: {counter.launches_dkv - before} "
                         f"backward launches, not {iters}")
    return dict(root=root, package=os.path.dirname(fa.__file__),
                iters=iters, seconds=seconds,
                mismatches=dict(zip(OUTPUTS, bad.tolist())))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", default=["."],
                    help="checkouts to hold, each in its own process")
    ap.add_argument("--iters", type=int, default=20000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the runs here")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one is not None:
        print(json.dumps(measure(args.one, args.iters, args.seed)))
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    runs = []
    for root in args.roots:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root,
             "--iters", str(args.iters), "--seed", str(args.seed)],
            capture_output=True, text=True)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"flash_repeat: {root} exited "
                             f"{proc.returncode}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print(smi.strip())
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(dict(device=smi.strip(), runs=runs), fh, indent=1)
    return 1 if any(any(r["mismatches"].values()) for r in runs) else 0


if __name__ == "__main__":
    sys.exit(main())
