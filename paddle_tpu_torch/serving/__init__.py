"""Serving on the port: the paged continuous-batching engine."""
from .engine import (EngineClosedError, EngineDeadError, Engine,
                     DeadlineExceededError, QueueFullError, RequestHandle)
from .paged_kv import PageAllocator
from .slot_pool import SlotPool

__all__ = ["Engine", "RequestHandle", "QueueFullError", "EngineClosedError",
           "EngineDeadError", "DeadlineExceededError", "PageAllocator",
           "SlotPool"]
