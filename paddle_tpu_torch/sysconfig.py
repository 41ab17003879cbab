"""``paddle.sysconfig`` (``paddle_tpu.sysconfig`` counterpart): the
directories an extension builds against: the port's C and CUDA sources
and headers (``kernels/csrc``)."""
from __future__ import annotations

import os

__all__ = ["get_include", "get_lib"]

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "kernels", "csrc")


def get_include() -> str:
    """The directory of the port's kernel headers (``sm90.cuh`` and the
    kernels' own)."""
    return _CSRC


def get_lib() -> str:
    """The directory of the kernel sources the port builds at first
    use."""
    return _CSRC
