"""Optimizers of the port (``paddle_tpu.optimizer`` counterparts)."""
from .optimizer import Adam, AdamW, Momentum, Optimizer

__all__ = ["Optimizer", "Momentum", "Adam", "AdamW"]
