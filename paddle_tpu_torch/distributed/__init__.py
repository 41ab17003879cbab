"""The single-device train step (``paddle_tpu.distributed`` counterpart;
meshes and collectives are ROADMAP module item 11)."""
from .spmd import ShardedTrainStep, make_train_step

__all__ = ["ShardedTrainStep", "make_train_step"]
