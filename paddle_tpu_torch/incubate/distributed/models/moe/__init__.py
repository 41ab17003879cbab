"""Mixture of experts (``paddle_tpu.incubate.distributed.models.moe``
counterparts): ``MoELayer``, the gates, the MoE clip and the routing
utilities, on one device."""
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate
from .grad_clip import ClipGradForMOEByGlobalNorm
from .moe_layer import MoELayer
from .utils import (_limit_by_capacity, _number_count,
                    _prune_gate_by_capacity, _random_routing, global_gather,
                    global_scatter)

__all__ = ["BaseGate", "GShardGate", "NaiveGate", "SwitchGate",
           "ClipGradForMOEByGlobalNorm", "MoELayer", "global_gather",
           "global_scatter", "_limit_by_capacity", "_number_count",
           "_prune_gate_by_capacity", "_random_routing"]
