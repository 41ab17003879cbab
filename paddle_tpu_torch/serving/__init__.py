"""Serving on the port: the paged continuous-batching engine, with the
decode fast path (prefix cache, speculative decoding, int8 pools)."""
from .engine import (EngineClosedError, EngineDeadError, Engine,
                     DeadlineExceededError, QueueFullError, RequestHandle)
from .paged_kv import PageAllocator
from .prefix_cache import PrefixEntry, PrefixIndex
from .slot_pool import SlotPool
from .speculative import NgramDrafter

__all__ = ["Engine", "RequestHandle", "QueueFullError", "EngineClosedError",
           "EngineDeadError", "DeadlineExceededError", "PageAllocator",
           "PrefixIndex", "PrefixEntry", "NgramDrafter", "SlotPool"]
