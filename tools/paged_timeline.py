"""Per-block timeline of the paged decode chunk kernel on one card.

Builds ``paddle_tpu_torch/kernels/csrc/paged_attention.cu`` with
``-DPADDLE_PAGED_TRACE`` into ``build/paged_timeline/``: the source's
``PAGED_TRACE`` points then make thread 0 of every chunk block write
``%globaltimer`` at eight points (block start after the live-item count,
copies issued, q and scales loaded, K and V arrived, scores done, chunk
softmax done, V pass done, partials written) and ``%smid``.  The wrapper
``paged_decode_attention`` is pointed at the traced library, one call of
each case runs after three warm-up calls, and the script prints, per
case and chunk length, the live blocks, the SMs they ran on and the most
on one SM, the spread of block starts and ends (µs from the first start)
and each phase's median, 90th percentile and max.

Usage, from the root of a checkout, with one CUDA card and ``nvcc``::

    python tools/paged_timeline.py [--chunks 32 64]
        [--out build/paged_timeline.json]

The cases are ``chip_smoke.py``'s ``PAGED_CASES`` (the first five; the
wide table's thousands of blocks add nothing a timeline shows).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

PHASES = ("issue copies", "q and scales", "K and V arrive", "scores",
          "softmax", "V pass", "write partials")


def build_traced():
    """Compile the source with its trace points; returns the loaded
    library."""
    from paddle_tpu_torch.kernels import _build

    csrc = _build.CSRC
    out = os.path.join(HERE, "build", "paged_timeline")
    os.makedirs(out, exist_ok=True)
    lib_path = os.path.join(out, "libpaged_traced.so")
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DPADDLE_PAGED_TRACE", "-I",
         str(csrc), "-shared", "-o", lib_path,
         str(csrc / "paged_attention.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"paged_timeline: nvcc failed\n{proc.stdout}\n"
                         f"{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in _build._SIGNATURES.items():
        if name.startswith("paddle_paged"):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    lib.paddle_paged_set_trace.argtypes = [ctypes.c_void_p]
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunks", type=int, nargs="+", default=[64])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import paged_attention as pa

    if not torch.cuda.is_available():
        raise SystemExit("paged_timeline: no CUDA card")
    lib = build_traced()
    _build.library = lambda: lib
    dev = torch.device("cuda", 0)
    res = {}
    for case in cs.PAGED_CASES[:5]:
        name, W, pool, n_pt, rows = case
        _, sets = cs._paged_inputs(dev, case, 2)
        for chunk in args.chunks:
            plan = pa.paged_plan(len(rows) + 1, W, cs.PAGED_H, cs.PAGED_D,
                                 cs.PAGED_P, n_pt, chunk_positions=chunk)

            def call(i, plan=plan):
                return pa._launch(*sets[i % 2], 1 / math.sqrt(cs.PAGED_D),
                                  pool == "int8", plan=plan)

            trace = torch.zeros(plan["grid"][0] * 9, dtype=torch.int64,
                                device=dev)
            for i in range(3):
                call(i)
            torch.cuda.synchronize()
            lib.paddle_paged_set_trace(trace.data_ptr())
            call(1)
            torch.cuda.synchronize()
            lib.paddle_paged_set_trace(None)
            t = trace.view(-1, 9).cpu().numpy()
            t = t[t[:, 0] != 0]                 # the live blocks
            rel = (t[:, :8] - t[:, 0].min()) / 1e3
            d = np.diff(t[:, :8], axis=1) / 1e3
            per_sm = np.bincount(t[:, 8].astype(int))
            key = f"{name} | chunk={chunk}"
            res[key] = dict(
                live_blocks=len(t), sms=int((per_sm > 0).sum()),
                most_on_one_sm=int(per_sm.max()),
                start_us=np.percentile(rel[:, 0], [0, 50, 90, 100])
                .round(3).tolist(),
                end_us=np.percentile(rel[:, 7], [0, 50, 90, 100])
                .round(3).tolist(),
                phase_us={p: [round(float(np.median(d[:, i])), 3),
                              round(float(np.percentile(d[:, i], 90)),
                                    3),
                              round(float(d[:, i].max()), 3)]
                          for i, p in enumerate(PHASES)})
            print(f"[timeline] {key}: {json.dumps(res[key])}",
                  flush=True)
        del sets
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
