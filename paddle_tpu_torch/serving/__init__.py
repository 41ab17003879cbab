"""Serving on the port: the paged continuous-batching engine, with the
decode fast path (prefix cache, speculative decoding, int8 pools),
multi-LoRA adapters and int8 base weights, the supervisor and the host
prefix tier."""
from .adapters import (AdapterError, AdapterRankError, AdapterRegistry,
                       AdapterShapeError, LoraAdapter, UnknownAdapterError,
                       make_lora, merge_into_qkv)
from .engine import (DeadlineExceededError, Engine, EngineClosedError,
                     EngineDeadError, EngineDrainingError,
                     EngineStalledError, QueueFullError, RequestHandle,
                     RequestInterruptedError)
from .kv_tier import HostPrefixEntry, HostPrefixTier
from .paged_kv import PageAllocator
from .prefix_cache import PrefixEntry, PrefixIndex
from .slot_pool import SlotPool
from .speculative import NgramDrafter
from .supervisor import EngineSupervisor

__all__ = ["Engine", "RequestHandle", "QueueFullError", "EngineClosedError",
           "EngineDrainingError", "EngineDeadError", "EngineStalledError",
           "RequestInterruptedError", "DeadlineExceededError",
           "EngineSupervisor", "HostPrefixTier", "HostPrefixEntry",
           "AdapterRegistry", "LoraAdapter", "make_lora", "merge_into_qkv",
           "AdapterError", "AdapterRankError", "AdapterShapeError",
           "UnknownAdapterError", "PageAllocator", "PrefixIndex",
           "PrefixEntry", "NgramDrafter", "SlotPool"]
