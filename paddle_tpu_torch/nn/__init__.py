"""The nn subset the port's models need."""
from . import functional
from .layer import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, CrossEntropyLoss,
                    Flatten, LayerNorm, Linear, MaxPool2D, ReLU, Sequential)

__all__ = ["functional", "LayerNorm", "BatchNorm2D", "Conv2D", "MaxPool2D",
           "AdaptiveAvgPool2D", "ReLU", "Linear", "Flatten", "Sequential",
           "CrossEntropyLoss"]
