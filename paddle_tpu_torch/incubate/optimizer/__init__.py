"""``paddle_tpu.incubate.optimizer`` counterpart: ``LookAhead``,
``ModelAverage`` and ``DistributedFusedLamb``."""
from .distributed_fused_lamb import DistributedFusedLamb  # noqa: F401
from .lookahead import LookAhead  # noqa: F401
from .modelaverage import ModelAverage  # noqa: F401
