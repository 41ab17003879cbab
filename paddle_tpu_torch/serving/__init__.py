"""Serving on the port: the paged continuous-batching engine, with the
decode fast path (prefix cache, speculative decoding, int8 pools),
multi-LoRA adapters and int8 base weights, the supervisor and the host
prefix tier.

The HTTP traffic layer (OpenAI-compatible completions, per-tenant
fair-share admission, telemetry-driven load shedding, multi-replica
routing) lives in :mod:`paddle_tpu_torch.serving.gateway`::

    from paddle_tpu_torch.serving.gateway import start_gateway
    stack = start_gateway([EngineSupervisor(factory)])  # POST /v1/completions

and the engine's metrics, flight events, journeys and device ledger in
:mod:`paddle_tpu_torch.observability`.

Replica count is a control loop: ``Autoscaler(stack, factory,
min_replicas=1, max_replicas=8)`` watches the gateway's windowed feed and
grows the fleet by a cold build or a warm spare's route-in
(``warm_pool=1``), and shrinks it only by drain.  ``FleetSim`` replays
the same ``ScalePolicy`` against virtual replicas.
``RolloutController(stack, factory_for_revision).rollout("r1")`` replaces
every replica with a new revision behind a ``CanaryGate``, rolling back
automatically when the canary misbehaves."""
from .autoscaler import Autoscaler, FleetSim, ScalePolicy
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
from .rollout import (CanaryGate, RolloutController, RolloutError,
                      RolloutResult, RolloutRolledBack)
from .slot_pool import SlotPool
from .speculative import NgramDrafter
from .supervisor import SERVING_RESTARTS, EngineSupervisor

__all__ = ["Engine", "Autoscaler", "ScalePolicy", "FleetSim",
           "RolloutController", "CanaryGate", "RolloutResult",
           "RolloutRolledBack", "RolloutError",
           "RequestHandle", "QueueFullError", "EngineClosedError",
           "EngineDrainingError", "EngineDeadError", "EngineStalledError",
           "RequestInterruptedError", "DeadlineExceededError",
           "EngineSupervisor", "SERVING_RESTARTS", "HostPrefixTier", "HostPrefixEntry",
           "AdapterRegistry", "LoraAdapter", "make_lora", "merge_into_qkv",
           "AdapterError", "AdapterRankError", "AdapterShapeError",
           "UnknownAdapterError", "PageAllocator", "PrefixIndex",
           "PrefixEntry", "NgramDrafter", "SlotPool"]
