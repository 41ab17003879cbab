"""``paddle.device.tpu`` (``paddle_tpu.device.tpu`` counterpart): the
accelerator's count and memory under XLA's key names, which in the port
describe the card (``observability.steps.memory_stats``: ``bytes_limit``,
``bytes_in_use``, ``peak_bytes_in_use``, ``largest_alloc_size``).
Without a card: 0 devices, ``{}`` and 0 bytes."""
from __future__ import annotations

import torch

from ..observability.steps import memory_stats as _memory_stats

__all__ = ["device_count", "memory_stats", "hbm_bytes"]


def device_count() -> int:
    return torch.cuda.device_count()


def memory_stats(device_id: int = 0) -> dict:
    return _memory_stats(device_id)


def hbm_bytes(device_id: int = 0) -> int:
    return int(memory_stats(device_id).get("bytes_limit", 0))
