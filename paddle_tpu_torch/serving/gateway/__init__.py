"""paddle_tpu_torch.serving.gateway — the multi-tenant HTTP front door.

The port's copy of ``paddle_tpu/serving/gateway``, with the same routes,
status codes, headers and JSON bodies, over the port's engines: an
OpenAI-compatible completions server (stdlib-only HTTP), priority classes
+ per-tenant weighted fair-share admission in front of the engine's FIFO,
telemetry-driven load shedding (estimated TTFT vs. request deadline ->
early structured 429 with ``Retry-After``), and a least-loaded router
over N engine replicas that fails over away from DEAD engines::

    from paddle_tpu_torch.serving import Engine, EngineSupervisor
    from paddle_tpu_torch.serving.gateway import TenantConfig, start_gateway

    stack = start_gateway(
        [EngineSupervisor(lambda: Engine(model, max_slots=8, max_len=512))],
        tenants=[TenantConfig("prod", priority="interactive", weight=4.0),
                 TenantConfig("batch", priority="batch", max_queue=64)],
        own_engines=True)
    print("listening on", stack.address)   # POST /v1/completions
    ...
    stack.close()

Fleet control sits on the same gateway: ``start_gateway(slo_objectives=
[...])`` attaches the burn-rate SLO engine (``/debug/slo``,
``/debug/incidents``), and :class:`~paddle_tpu_torch.serving.Autoscaler`
and :class:`~paddle_tpu_torch.serving.RolloutController` attach to a
stack for elastic replica counts and canary-gated upgrades
(``/debug/fleet``).
"""
from .admission import (  # noqa: F401
    AdmissionError,
    FairShareScheduler,
    TenantConfig,
)
from .gateway import (  # noqa: F401
    Gateway,
    GatewayClosedError,
    GatewayRequest,
)
from .http import (  # noqa: F401
    GatewayHTTPServer,
    GatewayStack,
    start_gateway,
)
from .protocol import (  # noqa: F401
    PRIORITIES,
    CompletionRequest,
    ProtocolError,
    parse_completion_request,
    tenant_from_headers,
)
from .router import EngineRouter, NoEngineAvailableError  # noqa: F401
from .shed import LoadShedder, ShedDecision  # noqa: F401

__all__ = [
    "AdmissionError", "CompletionRequest", "EngineRouter",
    "FairShareScheduler", "Gateway", "GatewayClosedError",
    "GatewayHTTPServer", "GatewayRequest", "GatewayStack", "LoadShedder",
    "NoEngineAvailableError", "PRIORITIES", "ProtocolError", "ShedDecision",
    "TenantConfig", "parse_completion_request", "start_gateway",
    "tenant_from_headers",
]
