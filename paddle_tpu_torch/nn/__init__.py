"""The nn subset the port's models need."""
from . import clip, functional
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_)
from .layer import (LSTM, AdaptiveAvgPool2D, BatchNorm2D, BCEWithLogitsLoss,
                    Conv2D, CrossEntropyLoss, CTCLoss, Flatten, GELU,
                    LayerList, LayerNorm, LeakyReLU, Linear, MaxPool2D,
                    MultiHeadAttention, ReLU, Sequential, Sigmoid, Swish,
                    Upsample, UpsamplingNearest2D)

__all__ = ["functional", "clip", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_", "LayerNorm",
           "BatchNorm2D", "Conv2D", "MaxPool2D", "AdaptiveAvgPool2D", "ReLU",
           "GELU", "Sigmoid", "LeakyReLU", "Swish", "Linear", "Flatten",
           "Upsample", "UpsamplingNearest2D", "Sequential", "LayerList",
           "CrossEntropyLoss", "BCEWithLogitsLoss", "CTCLoss", "LSTM",
           "MultiHeadAttention"]
