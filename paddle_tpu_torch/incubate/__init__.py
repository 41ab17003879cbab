"""``paddle_tpu.incubate`` counterparts: the MoE layer
(``distributed.models.moe``), auto-checkpoint (``checkpoint``:
``TrainEpochRange``) and ``sparse`` (the port's ``sparse``)."""
from . import checkpoint, distributed, sparse

__all__ = ["checkpoint", "distributed", "sparse"]
