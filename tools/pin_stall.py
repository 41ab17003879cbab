#!/usr/bin/env python3
"""Does pinning host memory on one thread stall another thread's CUDA calls?

The measurement behind the host prefix tier's pinned slab
(``paddle_tpu_torch/serving/kv_tier.py``): one thread times a loop of
small host-to-device copies and matrix products (what a serving engine's
scheduler issues) while a second thread allocates pinned host memory
(``torch.empty(..., pin_memory=True)``), at three allocation sizes; then it
times 40 MiB copies each way from pageable and from pinned host memory.
Prints the loop's median and longest call and its total, beside the
allocations' own time.  Needs one CUDA card::

    python3 tools/pin_stall.py
"""
import subprocess
import threading
import time

import torch


def _calls(src, dst, x, n=200):
    """(median ms, longest ms, total ms) of ``n`` copy + product calls."""
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        dst[:1 << 20].copy_(src[:1 << 20], non_blocking=True)
        x @ x
        ts.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    ts.sort()
    return 1e3 * ts[len(ts) // 2], 1e3 * ts[-1], 1e3 * sum(ts)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("pin_stall: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    src = torch.empty(48 << 20, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(48 << 20, dtype=torch.uint8, device=dev)
    x = torch.randn(1024, 1024, device=dev)
    torch.cuda.synchronize()
    _calls(src, dst, x)                                   # warm-up
    print("alone: median %.4f ms, longest %.3f ms, total %.2f ms"
          % _calls(src, dst, x))
    for size, n in ((1_500_000, 40), (60_000_000, 1), (600_000_000, 1)):
        stop, made = threading.Event(), []

        def pin():
            while not stop.is_set() and len(made) < n:
                t0 = time.perf_counter()
                made.append((torch.empty(size, dtype=torch.uint8,
                                         pin_memory=True),
                             time.perf_counter() - t0))

        th = threading.Thread(target=pin)
        th.start()
        res = _calls(src, dst, x)
        stop.set()
        th.join()
        print("beside %d pinned allocation(s) of %d bytes (%.2f ms each): "
              "median %.4f ms, longest %.3f ms, total %.2f ms"
              % ((len(made), size, 1e3 * sum(t for _, t in made)
                  / max(len(made), 1)) + res))
        del made
    n = 40 << 20
    out = {}
    for kind, host in (("pageable", torch.empty(n, dtype=torch.uint8)),
                       ("pinned", torch.empty(n, dtype=torch.uint8,
                                              pin_memory=True))):
        t0 = time.perf_counter()
        host.copy_(dst[:n])
        out[kind + " device-to-host"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dst[:n].copy_(host, non_blocking=True)
        torch.cuda.synchronize()
        out[kind + " host-to-device"] = time.perf_counter() - t0
    print("40 MiB copies: " + ", ".join(f"{k} {1e3 * v:.2f} ms"
                                        for k, v in out.items()))
    print(smi)


if __name__ == "__main__":
    main()
