"""Layers of the port (``paddle_tpu.nn.layer`` counterparts)."""
from .activation import ReLU
from .common import Flatten, Linear
from .container import Sequential
from .conv import Conv2D
from .loss import CrossEntropyLoss
from .norm import BatchNorm2D, LayerNorm
from .pooling import AdaptiveAvgPool2D, MaxPool2D

__all__ = ["LayerNorm", "BatchNorm2D", "Conv2D", "MaxPool2D",
           "AdaptiveAvgPool2D", "ReLU", "Linear", "Flatten", "Sequential",
           "CrossEntropyLoss"]
