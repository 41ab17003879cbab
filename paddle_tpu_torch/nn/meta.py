"""Abstract construction (``paddle_tpu.nn.meta`` counterpart).

Inside ``abstract_init()``, ``Layer.create_parameter`` makes each
parameter on torch's ``meta`` device: its shape and dtype only, no bytes
allocated and no initializer run, whatever ``with torch.device(...)``
block or place is active.  A model too large for the host can be built
so, to count and plan its parameters::

    with paddle.nn.abstract_init():
        model = MyNet()               # every parameter on "meta"

Buffers are made as usual (the JAX package's are concrete too).
"""
from __future__ import annotations

import contextlib
import threading

__all__ = ["abstract_init", "is_abstract_init"]

_state = threading.local()


def is_abstract_init() -> bool:
    return getattr(_state, "on", False)


@contextlib.contextmanager
def abstract_init(enable: bool = True):
    prev = getattr(_state, "on", False)
    _state.on = bool(enable)
    try:
        yield
    finally:
        _state.on = prev
