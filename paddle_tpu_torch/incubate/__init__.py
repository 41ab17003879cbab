"""``paddle_tpu.incubate`` counterparts: the MoE layer
(``distributed.models.moe``) and auto-checkpoint (``checkpoint``:
``TrainEpochRange``)."""
from . import checkpoint, distributed

__all__ = ["checkpoint", "distributed"]
