"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file compiles with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``.  No
PyTorch header is included, so a build takes seconds, not minutes.
``csrc/*.cuh`` headers are shared between sources and count in the hash
(``sm90.cuh``: the Hopper building blocks, TMA tensor maps among them;
``cuTensorMapEncodeTiled`` is fetched from the loaded driver library, so
nothing beyond the runtime is linked).

The build runs lazily, at the first kernel launch (never at import), into
``build/paddle_tpu_torch/<hash of the sources and flags>/`` under the
checkout, so an unchanged tree reuses its library and an edited source
builds anew.  Each source compiles in its own ``nvcc`` process, all
started together.  A missing ``nvcc`` or a failed build raises: nothing
falls back to the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["library", "build", "build_info", "BuildInfo", "NVCC_FLAGS",
           "check"]

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_S = ctypes.POINTER(ctypes.c_longlong)   # a host array of element strides
# C entry points and their argument types: pointers and the stream are
# c_void_p (a bare Python int would be cut to 32 bits), ints c_int
_SIGNATURES = {
    "paddle_flash_attention_fwd":
        [_P, _P, _P, _P, _P, _S, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    "paddle_flash_attention_smem_bytes": [_I],
    "paddle_flash_attention_bwd_dkv":
        [_P, _P, _P, _P, _P, _P, _P, _P, _S,
         _I, _I, _I, _I, _I, _F, _I, _I, _P],
    "paddle_flash_attention_bwd_dq":
        [_P, _P, _P, _P, _P, _P, _P, _S,
         _I, _I, _I, _I, _I, _F, _I, _I, _P],
    "paddle_flash_attention_bwd_delta":
        [_P, _P, _P, _S, _I, _I, _I, _I, _I, _P],
    "paddle_paged_decode_attention":
        [_P, _P, _P, _P, _P, _P, _P, _P,
         _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    "paddle_paged_attention_smem_bytes": [_I, _I, _I, _I],
    "paddle_paged_attention_max_w": [],
    "paddle_layer_norm_fwd":
        [_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _P],
    "paddle_layer_norm_bwd":
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "paddle_layer_norm_bwd_reduce": [_P, _P, _I, _I, _P],
    "paddle_layer_norm_bwd_blocks": [_I],
    "paddle_layer_norm_max_c": [_I],
    "paddle_ln_matmul":
        [_P, _L, _P, _P, _P, _L, _P, _I, _I, _I, _F, _I, _I, _I, _P],
    "paddle_conv_bn_gemm":
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
         _I, _I, _I, _I, _P],
    "paddle_conv_bn_colsum": [_P, _P, _I, _I, _P],
}


class BuildInfo:
    """What the last :func:`build` did: library path, wall seconds (0.0
    when an earlier build of the same sources was reused) and the
    compiler's ``-Xptxas -v`` report (registers, shared memory, spills)."""

    def __init__(self, path: Path, seconds: float, log: str, cached: bool):
        self.path = path
        self.seconds = seconds
        self.log = log
        self.cached = cached

    def ptxas_lines(self) -> list[str]:
        return [ln.strip() for ln in self.log.splitlines()
                if "Compiling entry" in ln or "Used" in ln or "spill" in ln]


_lock = threading.Lock()
_lib = None
_info = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
        "CUDA kernels of paddle_tpu_torch cannot be built")


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in [*srcs, *sorted(CSRC.glob("*.cuh"))]:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile the sources (or reuse a library built from identical ones)
    and return the :class:`BuildInfo`.  Raises ``RuntimeError`` naming
    the failing source and the compiler's output."""
    srcs = _sources()
    out_dir = BUILD_ROOT / _digest(srcs)
    lib_path = out_dir / "libpaddle_tpu_torch_kernels.so"
    log_path = out_dir / "build.log"
    if lib_path.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildInfo(lib_path, 0.0, log, cached=True)
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in srcs:
        obj = out_dir / (src.stem + ".o")
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = []
    failed = []
    for src, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{text}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    tmp = out_dir / f"lib.{os.getpid()}.tmp.so"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp),
         *[str(out_dir / (s.stem + ".o")) for s in srcs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    log = "\n".join(logs)
    log_path.write_text(log)
    return BuildInfo(lib_path, time.perf_counter() - t0, log, cached=False)


def library():
    """The loaded kernel library, built on first use (thread-safe)."""
    global _lib, _info
    with _lock:
        if _lib is None:
            info = build()
            lib = ctypes.CDLL(str(info.path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib, _info = lib, info
        return _lib


def build_info() -> BuildInfo:
    """The :class:`BuildInfo` of the loaded library (builds if needed)."""
    library()
    return _info


def check(err: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error (its
    ``cudaGetLastError()`` after the launch)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
