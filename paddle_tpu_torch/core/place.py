"""Places of the port (``paddle_tpu.core.place`` counterpart).

A ``Place`` names a torch device: ``CPUPlace()`` the CPU, ``CUDAPlace(i)``
card ``i``, ``CUDAPinnedPlace()`` page-locked host memory (a real
``pin_memory()``).  The current place starts as ``CUDAPlace(0)``; it is
resolved through :func:`paddle_tpu_torch.device.resolve_device`, so a
tensor made with no place and no card raises instead of landing on the
CPU (the JAX package falls back to the CPU quietly).  CPU scripts call
``set_device("cpu")`` first, as the tests do.  ``TPUPlace(i)`` names the
accelerator, card ``i``, as the JAX package's ``CUDAPlace`` names its
TPU.
"""
from __future__ import annotations

import torch

__all__ = ["Place", "CPUPlace", "CUDAPlace", "TPUPlace", "CUDAPinnedPlace",
           "set_device", "get_device", "device_count",
           "is_compiled_with_cuda", "is_compiled_with_rocm",
           "is_compiled_with_xpu", "is_compiled_with_tpu",
           "is_compiled_with_distribute"]


class Place:
    """Base place: ``Place("gpu", 0)``, ``Place("cpu")``."""

    def __init__(self, device_type: str, device_id: int = 0):
        self._type = device_type
        self._id = device_id

    @property
    def device_type(self) -> str:
        return self._type

    def get_device_id(self) -> int:
        return self._id

    def __eq__(self, other):
        return (isinstance(other, Place) and self._type == other._type
                and self._id == other._id)

    def __hash__(self):
        return hash((self._type, self._id))

    def __repr__(self):
        return f"Place({self._type}:{self._id})"

    def torch_device(self) -> torch.device:
        """The torch device; a card place without a card raises."""
        from ..device import resolve_device
        if self._type == "cpu":
            return torch.device("cpu")
        return resolve_device(f"cuda:{self._id}")


class CPUPlace(Place):
    def __init__(self):
        super().__init__("cpu", 0)


class CUDAPlace(Place):
    def __init__(self, device_id: int = 0):
        super().__init__("gpu", device_id)


class TPUPlace(CUDAPlace):
    """The accelerator place of TPU-era code: card ``device_id``."""


class CUDAPinnedPlace(CPUPlace):
    """Host memory that the card reads directly: tensors made here are
    ``pin_memory()`` copies (which needs a card)."""

    def __repr__(self):
        return "Place(gpu_pinned)"


_current_place: Place = CUDAPlace(0)


def set_device(device) -> Place:
    """``set_device("gpu")`` / ``("gpu:1")`` / ``("cuda")`` / ``("cpu")``
    or a ``Place``.  A card place without a card raises."""
    global _current_place
    if isinstance(device, Place):
        place = device
    else:
        name, _, idx = str(device).partition(":")
        if name == "cpu":
            place = CPUPlace()
        elif name in ("gpu", "cuda"):
            place = CUDAPlace(int(idx or 0))
        else:
            raise ValueError(f"unsupported device {device!r}: the port runs "
                             f"on 'cpu' or 'gpu[:N]'")
    place.torch_device()
    _current_place = place
    return place


def get_device() -> str:
    p = _current_place
    return "cpu" if p.device_type == "cpu" else f"gpu:{p.get_device_id()}"


def current_device() -> torch.device:
    """The torch device of the current place (raises without a card when
    the place is a card)."""
    return _current_place.torch_device()


def device_count() -> int:
    return torch.cuda.device_count()


def is_compiled_with_cuda() -> bool:
    return torch.version.cuda is not None


def is_compiled_with_rocm() -> bool:
    return torch.version.hip is not None


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_tpu() -> bool:
    return False


def is_compiled_with_distribute() -> bool:
    return torch.distributed.is_available()
