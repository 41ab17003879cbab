"""Utilities of the port (``paddle_tpu.utils`` counterparts): bounded
retries for flaky remote IO (:mod:`retry`), the build of the port's
native C++ pieces (:mod:`native_build`) and the legacy profiler facade
(``Profiler``, which lives in ``paddle_tpu_torch.profiler``)."""
from . import native_build, retry  # noqa: F401
from ..profiler import Profiler  # noqa: F401
from .retry import retry_call, retryable  # noqa: F401

__all__ = ["native_build", "retry", "retry_call", "retryable", "Profiler"]
