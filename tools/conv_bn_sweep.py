"""Every tile instance of the conv+BN wgmma kernels, and each way of
applying the prologue, at the experiment scripts' shapes, on one card.

Usage, from the root of a checkout, with one CUDA card::

    python tools/conv_bn_sweep.py [--out build/conv_bn_sweep.json]

Calls the C entry ``paddle_conv_bn_wgmma`` directly, so each shape runs
on every (BN, NWG) instance, not only the one ``conv_plan`` picks:

* 1x1 (M, K, N): the prologue in the kernel (in place in shared memory,
  on every slice), through the pass (``conv_bn_prologue`` then the
  kernel with none), and no prologue (the bare product); with the
  statistics;
* 3x3 (n, H, W, C, Co): the pass, then the kernel (which zeroes the taps
  outside the image); the pass alone beside it.

Device ms from CUDA-graph replays of 10 calls, inputs L2-warm (one set);
``torch.matmul`` / cuDNN ``conv2d`` beside them.  Prints one JSON line a
shape, the ``nvidia-smi`` name and power limit, and the plan's pick.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCES = ((64, 1), (64, 2), (128, 2), (256, 2))
SHAPES_1X1 = ((200704, 64, 256), (12544, 1024, 256), (13312, 1024, 256),
              (3136, 2048, 512), (12544, 256, 1024), (50176, 512, 128))
SHAPES_3X3 = ((64, 56, 56, 64, 64), (64, 28, 28, 128, 128),
              (64, 14, 14, 256, 256), (64, 7, 7, 512, 512),
              (8, 14, 14, 256, 256))


def graph_ms(fn, calls=10, replays=5):
    """Device ms of one call: ``calls`` calls in one CUDA graph, replayed
    ``replays`` times between CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
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
    return t0.elapsed_time(t1) / (calls * replays)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the rows as JSON")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch
    import torch.nn.functional as tF

    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import conv_bn as cb

    if not torch.cuda.is_available():
        raise SystemExit("conv_bn_sweep: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lib = _build.library()
    dev = torch.device("cuda", 0)
    sms = cb._sms(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def launch(x, s, b, w, y, M, K, N, hwc, pro, bn, nwg):
        """One call of instance (bn, nwg) with conv_plan's groups rule,
        the statistics and their column sum included."""
        H, W, C = hwc
        plan = cb.conv_plan(M, N, C or None, sms)
        occ = 2 if nwg == 1 else 1
        groups = max(1, min(-(-M // (64 * nwg)), occ * sms // -(-N // bn)))
        part = torch.empty(2, groups, N, device=dev)

        def call():
            err = lib.paddle_conv_bn_wgmma(
                x.data_ptr(), s.data_ptr(), b.data_ptr(), w.data_ptr(),
                y.data_ptr(), part.data_ptr(), M, K, N, H, W, C, pro, 1,
                int(C > 0), bn, nwg, groups,
                torch.cuda.current_stream().cuda_stream)
            _build.check(err, "conv_bn_sweep")
            cb.conv_bn_column_sum(part)
        return call, plan

    def inputs(x_shape, C, w_shape, fan_in):
        x = torch.randn(x_shape, device=dev, generator=gen).to(torch.bfloat16)
        s = 1 + 0.1 * torch.randn(C, device=dev, generator=gen)
        b = 0.1 * torch.randn(C, device=dev, generator=gen)
        w = (torch.randn(w_shape, device=dev, generator=gen)
             / fan_in ** 0.5).to(torch.bfloat16)
        return x, s, b, w

    rows = []
    for M, K, N in SHAPES_1X1:
        x, s, b, w = inputs((M, K), K, (K, N), K)
        y = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
        row = dict(shape=f"1x1 M={M} K={K} N={N}",
                   matmul_ms=graph_ms(lambda: torch.matmul(x, w)),
                   pass_ms=graph_ms(lambda: cb.conv_bn_prologue(x, s, b)))
        xp = cb.conv_bn_prologue(x, s, b)
        for bn, nwg in INSTANCES:
            if bn > 64 and N <= bn // 2:
                continue
            f_in, plan = launch(x, s, b, w, y, M, K, N, (0, 0, 0), 1, bn,
                                nwg)
            f_none, _ = launch(xp, s, b, w, y, M, K, N, (0, 0, 0), 0, bn,
                               nwg)
            row[f"{bn}x{nwg}"] = dict(in_kernel=graph_ms(f_in),
                                      no_prologue=graph_ms(f_none))
        row["plan"] = plan
        rows.append(row)
        print(json.dumps(row), flush=True)
    for n, H, W, C, Co in SHAPES_3X3:
        M = n * H * W
        x, s, b, w = inputs((n, H, W, C), C, (3, 3, C, Co), 9 * C)
        xp = cb.conv_bn_prologue(x, s, b)
        y = torch.empty(M, Co, dtype=torch.bfloat16, device=dev)
        xn = xp.permute(0, 3, 1, 2)
        wl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        row = dict(shape=f"3x3 n={n} {H}x{W} C={C}->{Co}",
                   conv2d_ms=graph_ms(lambda: tF.conv2d(xn, wl, padding=1)),
                   pass_ms=graph_ms(lambda: cb.conv_bn_prologue(x, s, b)))
        for bn, nwg in INSTANCES:
            if bn > 64 and Co <= bn // 2:
                continue
            f, plan = launch(xp, s, b, w, y, M, 9 * C, Co, (H, W, C), 2, bn,
                             nwg)
            row[f"{bn}x{nwg}"] = dict(after_pass=graph_ms(f))
        row["plan"] = plan
        rows.append(row)
        print(json.dumps(row), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(dict(device=smi, rows=rows), fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
