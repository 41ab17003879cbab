"""``paddle_tpu.incubate`` counterparts: the MoE layer
(``distributed.models.moe``)."""
from . import distributed

__all__ = ["distributed"]
