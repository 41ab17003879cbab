"""The nn subset the port's models need."""
from . import clip, functional
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_)
from .layer import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, CrossEntropyLoss,
                    Flatten, LayerNorm, Linear, MaxPool2D, ReLU, Sequential)

__all__ = ["functional", "clip", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_", "LayerNorm", "BatchNorm2D", "Conv2D", "MaxPool2D",
           "AdaptiveAvgPool2D", "ReLU", "Linear", "Flatten", "Sequential",
           "CrossEntropyLoss"]
