"""``paddle.framework`` counterpart: ``save`` / ``load``, the sharded
checkpoints (:mod:`checkpoint`), preemption (:mod:`preemption`) and the
core re-exports."""
from . import checkpoint, preemption  # noqa: F401
from .io import load, save  # noqa: F401
from ..core.dtype import get_default_dtype, set_default_dtype  # noqa: F401
from ..core.random import seed  # noqa: F401
from ..core.tensor import Tensor  # noqa: F401
