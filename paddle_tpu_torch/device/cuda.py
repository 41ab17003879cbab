"""``paddle.device.cuda`` over ``torch.cuda`` (``paddle_tpu.device.cuda``
counterpart): memory statistics, synchronisation, streams and events of
the card.  ``device`` arguments take an int, a ``CUDAPlace`` or a torch
device; ``None`` is the current card."""
from __future__ import annotations

import torch

from ..core.place import Place

__all__ = ["device_count", "memory_allocated", "max_memory_allocated",
           "memory_reserved", "max_memory_reserved", "empty_cache",
           "synchronize", "get_device_properties", "get_device_name",
           "get_device_capability", "Stream", "Event", "current_stream",
           "stream_guard"]


def _dev(device):
    if isinstance(device, Place):
        return device.get_device_id()
    return device


def device_count() -> int:
    return torch.cuda.device_count()


def memory_allocated(device=None) -> int:
    return torch.cuda.memory_allocated(_dev(device))


def max_memory_allocated(device=None) -> int:
    return torch.cuda.max_memory_allocated(_dev(device))


def memory_reserved(device=None) -> int:
    return torch.cuda.memory_reserved(_dev(device))


def max_memory_reserved(device=None) -> int:
    return torch.cuda.max_memory_reserved(_dev(device))


def empty_cache():
    torch.cuda.empty_cache()


def synchronize(device=None):
    torch.cuda.synchronize(_dev(device))


def get_device_properties(device=None):
    return torch.cuda.get_device_properties(_dev(device) or 0)


def get_device_name(device=None) -> str:
    return torch.cuda.get_device_name(_dev(device))


def get_device_capability(device=None):
    return torch.cuda.get_device_capability(_dev(device))


Stream = torch.cuda.Stream
Event = torch.cuda.Event


def current_stream(device=None) -> torch.cuda.Stream:
    return torch.cuda.current_stream(_dev(device))


def stream_guard(stream):
    """Run the block's work on ``stream``."""
    return torch.cuda.stream(stream)
