"""The single-device train step (``paddle_tpu.distributed`` counterpart;
meshes and collectives are ROADMAP module item 11), the launcher's
environment (:func:`get_rank`, :func:`get_world_size`) and
``fleet.utils``'s filesystem clients."""
from . import fleet  # noqa: F401
from .env import get_rank, get_world_size
from .spmd import ShardedTrainStep, make_train_step

__all__ = ["ShardedTrainStep", "make_train_step", "fleet", "get_rank",
           "get_world_size"]
