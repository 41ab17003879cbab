"""``paddle_tpu.utils.deprecated`` counterpart: a decorator that stamps a
deprecation notice on the function's docstring and, at ``level`` 1,
warns on each call (at ``level`` 2 it raises at once)."""
from __future__ import annotations

import functools
import warnings

__all__ = ["deprecated"]


def deprecated(update_to="", since="", reason="", level=0):
    def decorator(func):
        msg = f"API \"{func.__module__}.{func.__name__}\" is deprecated"
        if since:
            msg += f" since {since}"
        if update_to:
            msg += f", and will be removed in future versions. Please use "\
                   f"\"{update_to}\" instead"
        if reason:
            msg += f". Reason: {reason}"
        if func.__doc__:
            func.__doc__ = ("\n\nWarning:\n    " + msg + "\n\n"
                            + func.__doc__)
        if level == 2:
            raise RuntimeError(msg)

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            if level == 1:
                warnings.warn(msg, DeprecationWarning, stacklevel=2)
            return func(*args, **kwargs)

        return wrapper

    return decorator
