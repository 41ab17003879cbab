"""``paddle.incubate.sparse.nn``: the sparse Layers (``ReLU``, ``ReLU6``,
``LeakyReLU``, ``Softmax``, ``Conv3D``, ``SubmConv3D``, ``MaxPool3D``) of
``sparse.nn``."""
from ...sparse.nn import (Conv3D, LeakyReLU, MaxPool3D, ReLU,  # noqa: F401
                          ReLU6, Softmax, SubmConv3D)

__all__ = ["ReLU", "ReLU6", "LeakyReLU", "Softmax",
           "Conv3D", "SubmConv3D", "MaxPool3D"]
