"""Optimizers of the port (``paddle_tpu.optimizer`` counterparts)."""
from . import lr
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax,  # noqa: F401
                        AdamW, L1Decay, L2Decay, Lamb, LarsMomentum,
                        Momentum, Optimizer, RMSProp)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "RMSProp", "Adadelta", "Adamax", "Lamb", "LarsMomentum",
           "L1Decay", "L2Decay"]
