"""Layers of the port (``paddle_tpu.nn.layer`` counterparts)."""
from .activation import GELU, LeakyReLU, ReLU, Sigmoid, Swish
from .common import Flatten, Linear, Upsample, UpsamplingNearest2D
from .container import LayerList, Sequential
from .conv import Conv2D
from .loss import BCEWithLogitsLoss, CrossEntropyLoss, CTCLoss
from .norm import BatchNorm2D, LayerNorm
from .pooling import AdaptiveAvgPool2D, MaxPool2D
from .rnn import LSTM
from .transformer import MultiHeadAttention

__all__ = ["LayerNorm", "BatchNorm2D", "Conv2D", "MaxPool2D",
           "AdaptiveAvgPool2D", "ReLU", "GELU", "Sigmoid", "LeakyReLU",
           "Swish", "Linear", "Flatten", "Upsample", "UpsamplingNearest2D",
           "Sequential", "LayerList", "CrossEntropyLoss",
           "BCEWithLogitsLoss", "CTCLoss", "LSTM", "MultiHeadAttention"]
