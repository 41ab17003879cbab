"""``paddle_tpu.incubate`` counterparts: the fused transformer family
(``nn``), ``operators`` (graph ops, softmax-mask fusions, ``ResNetUnit``),
``optimizer`` (``LookAhead``, ``ModelAverage``,
``DistributedFusedLamb``), ``tensor`` and the segment reductions, the
MoE layer (``distributed.models.moe``), auto-checkpoint (``checkpoint``:
``TrainEpochRange``), ``sparse`` (the port's ``sparse``), functional
autodiff (``autograd``), n:m sparsity (``asp``), ``autotune``, Tensors
across processes (``multiprocessing``) and ``passes``."""
from . import (asp, autograd, autotune, checkpoint,  # noqa: F401
               distributed, multiprocessing, nn, operators, optimizer,
               passes, sparse, tensor)
from .tensor import (segment_max, segment_mean, segment_min,  # noqa: F401
                     segment_sum)

__all__ = ["asp", "autograd", "autotune", "checkpoint", "distributed",
           "multiprocessing", "nn", "operators", "optimizer", "passes",
           "sparse", "tensor", "segment_sum", "segment_mean", "segment_max",
           "segment_min"]
