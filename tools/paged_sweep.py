"""Times the paged decode kernel (row 7) under other chunk lengths, on one
card: every case of ``chip_smoke.py``'s ``PAGED_CASES`` at each chunk
length given on the command line (``paged_plan``'s ``chunk_positions``,
at most 64).

Usage, from the root of a checkout, with one CUDA card::

    python tools/paged_sweep.py [--chunks 16 32 64]
        [--out build/paged_sweep.json]

Each plan is passed to the kernel's launch explicitly (``_launch``'s
``plan``), held against the plain version at 1e-4 on the case's first
pool set, then timed by CUDA-graph replays over the case's rotating pool
sets (``chip_smoke._graph_ms``); 20 eager calls under ``torch.profiler``
split the device time by kernel (the chunk kernel and the merge kernel).
Prints one line a chunk length and case, the ``nvidia-smi`` name and
power limit, and one JSON object of every time.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunks", type=int, nargs="+", default=[16, 32, 64])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.kernels import paged_attention as pa

    if not torch.cuda.is_available():
        raise SystemExit("paged_sweep: no CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    res = {}
    for case in cs.PAGED_CASES:
        name, W, pool, n_pt, _ = case
        _, sets = cs._paged_inputs(dev, case, cs._paged_n_sets(case))
        live = sets[0][4] < n_pt * cs.PAGED_P
        ref = pa.paged_decode_attention_plain(*sets[0])
        quant = pool == "int8"
        for chunk in args.chunks:
            plan = pa.paged_plan(len(live), W, cs.PAGED_H, cs.PAGED_D,
                                 cs.PAGED_P, n_pt, chunk_positions=chunk)

            def call(*a, plan=plan):
                return pa._launch(*a, 1 / math.sqrt(cs.PAGED_D), quant,
                                  plan=plan)

            out = call(*sets[0])
            err = float((out[live] - ref[live]).abs().max())
            if not err <= 1e-4:
                raise SystemExit(f"paged_sweep: {name} chunk={chunk}: max "
                                 f"abs err {err}")
            ms = cs._graph_ms(cs._rotating(call, sets), 10)
            prof = cs._device_profile(lambda: [call(*sets[0])
                                               for _ in range(20)])
            split = {k[:70]: v / 20 for k, v in
                     prof["all_kernels_ms"].items()}
            key = f"{name} | chunk={chunk}"
            res[key] = dict(ms=ms, max_abs_err=err, kernels_ms=split,
                            chunk=plan["chunk"], grid=plan["grid"])
            print(f"[paged-sweep] {key}: {ms:.4f} ms (chunk {plan['chunk']}"
                  f", grid {plan['grid']}, err {err:.2e}); "
                  + ", ".join(f"{k} {v:.4f}" for k, v in split.items()),
                  flush=True)
        del sets, ref
        torch.cuda.empty_cache()
    print(smi)
    print(json.dumps(res))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(dict(device=smi, runs=res), fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
