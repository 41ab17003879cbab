"""Device resolution for the port's entry points, and the
``paddle.device`` surface (``paddle_tpu.device`` counterpart) over
``torch.cuda``."""
from __future__ import annotations

import torch

from ..core.place import (CPUPlace, CUDAPinnedPlace, CUDAPlace,  # noqa: F401
                          Place, TPUPlace, device_count, get_device,
                          is_compiled_with_cuda, is_compiled_with_distribute,
                          is_compiled_with_rocm, is_compiled_with_tpu,
                          is_compiled_with_xpu, set_device)

__all__ = ["resolve_device", "Place", "CPUPlace", "CUDAPlace", "TPUPlace",
           "CUDAPinnedPlace", "set_device", "get_device", "device_count",
           "is_compiled_with_cuda", "is_compiled_with_rocm",
           "is_compiled_with_xpu", "is_compiled_with_tpu",
           "is_compiled_with_distribute", "get_all_device_type",
           "get_available_device", "get_available_custom_device",
           "synchronize", "cuda", "tpu"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device without a card raises
    ``RuntimeError``: the port never drops to the CPU on its own — the
    caller asks for ``device="cpu"`` explicitly (the tests do)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available (torch.cuda.is_available() is "
            "False); pass device='cpu' to run the plain PyTorch path")
    return dev


def get_all_device_type() -> list:
    return ["cpu", "gpu"] if torch.cuda.is_available() else ["cpu"]


def get_available_device() -> list:
    return ["cpu"] + [f"gpu:{i}" for i in range(torch.cuda.device_count())]


def get_available_custom_device() -> list:
    return []


def synchronize(device=None):
    """Block until the card's queued work is done (nothing without a
    card)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize(device)


from . import cuda, tpu  # noqa: E402,F401
