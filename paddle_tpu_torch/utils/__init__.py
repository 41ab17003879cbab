"""Utilities of the port (``paddle_tpu.utils`` counterparts, the same
public names): bounded retries for flaky remote IO (:mod:`retry`), the
build of native C++ pieces (:mod:`native_build`), C++ custom ops
(:mod:`cpp_extension`), :mod:`dlpack`, :mod:`unique_name`,
``deprecated``, local archives (:mod:`download`), ``try_import``,
``require_version``, ``run_check``, the legacy profiler facade
(``Profiler``, ``ProfilerOptions``, ``get_profiler``),
``OpLastCheckpointChecker`` and ``image_util`` (``dataset.image``)."""
from . import cpp_extension, dlpack, download  # noqa: F401
from . import native_build, retry, unique_name  # noqa: F401
from ..profiler import Profiler  # noqa: F401
from .deprecated import deprecated  # noqa: F401
from .native_build import build_native_lib, get_build_directory  # noqa: F401
from .retry import retry_call, retryable  # noqa: F401


def try_import(name):
    """The module ``name``, or None where it cannot be imported."""
    import importlib
    try:
        return importlib.import_module(name)
    except ImportError:
        return None


def require_version(min_version, max_version=None):
    """Raise unless the port's version lies in ``[min_version,
    max_version]``."""
    from ..version import full_version as v

    def parse(s):
        return tuple(int(p) for p in str(s).split(".")[:3] if p.isdigit())

    if parse(v) < parse(min_version):
        raise Exception(
            f"installed version {v} < required {min_version}")
    if max_version is not None and parse(v) > parse(max_version):
        raise Exception(
            f"installed version {v} > maximum {max_version}")


def run_check():
    """The install check: one SGD step of a ``Linear(4, 4)`` on the
    current place (the card unless the CPU was set), then a report."""
    import numpy as np

    import paddle_tpu_torch as paddle
    from .. import nn

    paddle.seed(0)
    lin = nn.Linear(4, 4)
    opt = paddle.optimizer.SGD(learning_rate=0.1,
                               parameters=lin.parameters())
    x = paddle.to_tensor(np.ones((2, 4), np.float32))
    loss = (lin(x) ** 2).mean()
    loss.backward()
    opt.step()
    print(f"paddle_tpu_torch is installed successfully on "
          f"{x.value.device}!")


class ProfilerOptions:
    def __init__(self, options=None):
        self.options = options or {}


def get_profiler():
    return Profiler


class OpLastCheckpointChecker:
    """The op-version checker: every op of the port is current."""

    def check(self, op_name, *a, **k):
        return True


from ..dataset import image as image_util  # noqa: E402,F401

__all__ = ["cpp_extension", "dlpack", "download", "native_build", "retry",
           "unique_name", "deprecated", "build_native_lib",
           "get_build_directory", "retry_call", "retryable", "try_import",
           "require_version", "run_check", "Profiler", "ProfilerOptions",
           "get_profiler", "OpLastCheckpointChecker", "image_util"]
