"""``paddle.sparse.nn``: sparse Layers over the ``sparse`` ops.

``Conv3D`` / ``SubmConv3D`` hold a ``[kd, kh, kw, Ci, Co]`` weight and a
``[Co]`` bias (the JAX package's parameters, so a state dict carries
across); ``MaxPool3D``, ``ReLU``, ``ReLU6``, ``LeakyReLU`` and
``Softmax`` hold none.  They take and return sparse tensors.
"""
from __future__ import annotations

from ...nn.layer_base import Layer, param
from .. import binary, conv, unary
from . import functional  # noqa: F401

__all__ = ["Conv3D", "SubmConv3D", "MaxPool3D", "ReLU", "ReLU6",
           "LeakyReLU", "Softmax", "functional"]


class Conv3D(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, subm=False,
                 data_format="NDHWC", weight_attr=None, bias_attr=None):
        super().__init__()
        kd, kh, kw = conv._to3(kernel_size)
        self.weight = self.create_parameter(
            [kd, kh, kw, in_channels, out_channels], attr=weight_attr)
        self.bias = self.create_parameter([out_channels], attr=bias_attr,
                                          is_bias=True)
        self._args = (stride, padding, dilation, groups, subm, data_format)

    def forward(self, x):
        stride, padding, dilation, groups, subm, fmt = self._args
        return conv.conv3d(x, param(self, "weight"), param(self, "bias"),
                           stride, padding, dilation, groups,
                           data_format=fmt, subm=subm)


class SubmConv3D(Conv3D):
    def __init__(self, *args, **kwargs):
        kwargs["subm"] = True
        super().__init__(*args, **kwargs)


class MaxPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self._args = (kernel_size, stride, padding)

    def forward(self, x):
        return conv.max_pool3d(x, *self._args)


class ReLU(Layer):
    def forward(self, x):
        return unary.relu(x)


class ReLU6(Layer):
    def forward(self, x):
        return unary.relu6(x)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01):
        super().__init__()
        self._slope = negative_slope

    def forward(self, x):
        return unary.leaky_relu(x, self._slope)


class Softmax(Layer):
    def __init__(self, axis=-1):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return binary.softmax(x, self._axis)
