"""Build of the port's native C++ pieces (the shared-memory ring of the
DataLoader's workers, ``io/csrc/shm_ring.cpp``).

The counterpart of ``paddle_tpu/utils/native_build.py``, with the
port's build layout: a source compiles with ``g++`` at its first use
(never at import) into ``build/paddle_tpu_torch/native/<digest>/``
beside the kernels' builds (``build/`` is not committed), keyed by a
digest of the source and the flags, so an edit builds anew.  Each
process writes a temporary file of its own and renames it into place,
so concurrent first uses (test workers, ranks) are safe.  A missing
compiler or a failed build raises.  ``cpp_extension`` builds users' ops
the same way, into ``build_dir`` when it is given.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / \
    "paddle_tpu_torch" / "native"

CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")


def get_build_directory() -> str:
    """The directory the native builds go to (``BUILD_ROOT``)."""
    return str(BUILD_ROOT)


def build_native_lib(src_path: str, so_name: str,
                     extra_flags: tuple = (),
                     build_dir: str | None = None) -> str:
    """Compile ``src_path`` into ``<build_dir>/<digest>/<so_name>`` (once
    per digest; ``build_dir`` defaults to ``BUILD_ROOT``); returns the
    library's path."""
    cxx = os.environ.get("CXX", "g++")
    flags = (*CXX_FLAGS, *extra_flags)
    h = hashlib.sha256(Path(src_path).read_bytes())
    h.update(" ".join((cxx, *flags)).encode())
    out_dir = Path(build_dir or BUILD_ROOT) / h.hexdigest()[:16]
    so = out_dir / so_name
    if so.exists():
        return str(so)
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{so_name}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, src_path, "-o", str(tmp), *extra_flags]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except FileNotFoundError:
        raise RuntimeError(f"native build needs a C++ compiler: {cxx!r} "
                           f"was not found") from None
    except subprocess.CalledProcessError as e:
        raise RuntimeError(
            f"native build failed: {' '.join(cmd)}\n"
            f"{e.stderr.decode(errors='replace')[-2000:]}") from None
    os.replace(tmp, so)
    return str(so)
