"""paddle_tpu_torch.serving.adapters — multi-LoRA adapters and int8 base
weights for the serving engine::

    from paddle_tpu_torch.serving import Engine
    from paddle_tpu_torch.serving.adapters import AdapterRegistry, make_lora

    reg = AdapterRegistry(model, max_resident=4, max_rank=8)
    reg.register(make_lora(cfg, rank=4, seed=1, name="tenant-a"))
    engine = Engine(model, adapters=reg)
    engine.submit(prompt, adapter="tenant-a")     # LoRA-decoded
    engine.submit(prompt)                         # base model (bank row 0)

The per-row bank ids are one more static input of the captured decode
graph; resident adapters live in stacked device banks (:mod:`lora`), bank
residency is refcount + LRU (:mod:`registry`), and the base weights can be
stored int8 (``Engine(weight_dtype="int8")``, :mod:`weight_quant`).
"""
from .lora import (  # noqa: F401
    LoraAdapter,
    adapter_scope,
    make_lora,
    merge_into_qkv,
)
from .registry import (  # noqa: F401
    AdapterError,
    AdapterRankError,
    AdapterRegistry,
    AdapterResidency,
    AdapterShapeError,
    UnknownAdapterError,
)

__all__ = ["LoraAdapter", "make_lora", "merge_into_qkv", "adapter_scope",
           "AdapterRegistry", "AdapterResidency", "AdapterError",
           "AdapterShapeError", "AdapterRankError", "UnknownAdapterError"]
