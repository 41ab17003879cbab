"""``paddle_tpu.utils.dlpack`` counterpart: ``to_dlpack`` / ``from_dlpack``
over ``torch.utils.dlpack``, zero-copy on the tensor's device (a card
tensor's capsule names its device memory)."""
from __future__ import annotations

from torch.utils import dlpack as _dlpack

from ..core.tensor import Tensor

__all__ = ["to_dlpack", "from_dlpack"]


def to_dlpack(x):
    v = x._value if isinstance(x, Tensor) else x
    return _dlpack.to_dlpack(v.detach())


def from_dlpack(dlpack):
    return Tensor._wrap(_dlpack.from_dlpack(dlpack))
