"""Optimizers of the port (``paddle_tpu.optimizer`` counterparts)."""
from . import lr
from .optimizer import Adam, AdamW, L1Decay, L2Decay, Momentum, Optimizer

__all__ = ["lr", "Optimizer", "Momentum", "Adam", "AdamW", "L1Decay",
           "L2Decay"]
