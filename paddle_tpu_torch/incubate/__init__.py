"""``paddle_tpu.incubate`` counterparts: the fused transformer family
(``nn``), ``operators`` (graph ops, softmax-mask fusions, ``ResNetUnit``),
``optimizer`` (``LookAhead``, ``ModelAverage``,
``DistributedFusedLamb``), ``tensor`` and the segment reductions, the
MoE layer (``distributed.models.moe``), auto-checkpoint (``checkpoint``:
``TrainEpochRange``) and ``sparse`` (the port's ``sparse``)."""
from . import (checkpoint, distributed, nn, operators,  # noqa: F401
               optimizer, sparse, tensor)
from .tensor import (segment_max, segment_mean, segment_min,  # noqa: F401
                     segment_sum)

__all__ = ["checkpoint", "distributed", "nn", "operators", "optimizer",
           "sparse", "tensor", "segment_sum", "segment_mean", "segment_max",
           "segment_min"]
