"""Channels-last construction (``paddle_tpu.nn.layout`` counterpart).

Inside ``channels_last()`` every image layer built with a channel-first
``data_format`` (the paddle default: ``NCHW``, ``NCL``, ``NCDHW``) takes
the channel-last one instead; an explicit channel-last argument passes
through.  The conv, pool, norm and common image layers resolve their
``data_format`` through :func:`resolve_data_format` when they are built,
the 1-D pools and the adaptive max pools included (their signatures
carry no ``data_format``).  Parameter shapes do not change (conv weights
stay ``[out, in, *k]``), so state dicts move between the two layouts.

The scope is per thread; ``set_global_channels_last`` sets the process
default that a thread without a scope sees.
"""
from __future__ import annotations

import contextlib
import threading

__all__ = ["channels_last", "is_channels_last", "resolve_data_format",
           "set_global_channels_last"]

_state = threading.local()
# the process default: a thread-local alone would hide it from layers
# built on other threads
_global_on = False


def set_global_channels_last(flag: bool):
    global _global_on
    _global_on = bool(flag)


_TO_CHANNEL_LAST = {
    "NCHW": "NHWC",
    "NCL": "NLC",
    "NCDHW": "NDHWC",
}


def is_channels_last() -> bool:
    """True inside a ``channels_last()`` scope of this thread, or under
    the process default."""
    return getattr(_state, "on", _global_on)


@contextlib.contextmanager
def channels_last(enable: bool = True):
    """Construction scope: image layers default to channel-last layouts."""
    had = hasattr(_state, "on")
    prev = getattr(_state, "on", None)
    _state.on = bool(enable)
    try:
        yield
    finally:
        # restore exactly: a stale thread-local False would hide the
        # process default for good
        if had:
            _state.on = prev
        else:
            del _state.on


def resolve_data_format(data_format: str) -> str:
    """``data_format`` made channel-last inside ``channels_last()``,
    otherwise as given."""
    if data_format and is_channels_last():
        return _TO_CHANNEL_LAST.get(data_format, data_format)
    return data_format
