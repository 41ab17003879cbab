"""Utilities of the port (``paddle_tpu.utils`` counterparts): bounded
retries for flaky remote IO (:mod:`retry`) and the build of the port's
native C++ pieces (:mod:`native_build`)."""
from . import native_build, retry  # noqa: F401
from .retry import retry_call, retryable  # noqa: F401

__all__ = ["native_build", "retry", "retry_call", "retryable"]
