"""Activation layers (``paddle_tpu.nn.layer.activation`` counterparts):
the 27 the JAX package exports.

Each calls its ``F`` functional.  As in the JAX package, positional
arguments map onto the functional's keyword order after ``x``
(``LeakyReLU(0.2)`` is ``negative_slope=0.2``, ``GELU(True)`` is
``approximate=True``, ``Softmax(0)`` is ``axis=0``) and ``name`` is
dropped.  ``RReLU`` is the functional's eval form unless called with
``training=True`` (as the JAX layer, which passes no mode); ``PReLU``
holds its slopes as ``weight`` ``[num_parameters]``, filled with
``init``."""
from __future__ import annotations

import inspect

from .. import functional as F
from .. import initializer as I
from ..layer_base import Layer, param

__all__ = ["ReLU", "ReLU6", "ELU", "SELU", "CELU", "GELU", "Sigmoid",
           "LogSigmoid", "Hardsigmoid", "Hardswish", "Hardtanh",
           "Hardshrink", "Softshrink", "Tanhshrink", "LeakyReLU", "Softplus",
           "Softsign", "Silu", "Swish", "Mish", "Tanh", "Softmax",
           "LogSoftmax", "Maxout", "GLU", "RReLU", "PReLU"]


class _Activation(Layer):
    _fn = None      # the functional's name in ``F``

    def __init__(self, *args, **kwargs):
        super().__init__()
        fn = getattr(F, self._fn)
        names = list(inspect.signature(fn).parameters)[1:]
        self._kwargs = dict(zip(names, args))
        self._kwargs.update({k: v for k, v in kwargs.items() if k != "name"})

    def forward(self, x):
        return getattr(F, self._fn)(x, **self._kwargs)

    def extra_repr(self):
        return ", ".join(f"{k}={v}" for k, v in self._kwargs.items())


def _activation(cls_name, fn_name):
    return type(cls_name, (_Activation,), {"_fn": fn_name,
                                           "__module__": __name__})


ReLU = _activation("ReLU", "relu")
ReLU6 = _activation("ReLU6", "relu6")
ELU = _activation("ELU", "elu")
SELU = _activation("SELU", "selu")
CELU = _activation("CELU", "celu")
GELU = _activation("GELU", "gelu")
Sigmoid = _activation("Sigmoid", "sigmoid")
LogSigmoid = _activation("LogSigmoid", "log_sigmoid")
Hardsigmoid = _activation("Hardsigmoid", "hardsigmoid")
Hardswish = _activation("Hardswish", "hardswish")
Hardtanh = _activation("Hardtanh", "hardtanh")
Hardshrink = _activation("Hardshrink", "hardshrink")
Softshrink = _activation("Softshrink", "softshrink")
Tanhshrink = _activation("Tanhshrink", "tanhshrink")
LeakyReLU = _activation("LeakyReLU", "leaky_relu")
Softplus = _activation("Softplus", "softplus")
Softsign = _activation("Softsign", "softsign")
Silu = _activation("Silu", "silu")
Swish = _activation("Swish", "swish")
Mish = _activation("Mish", "mish")
Tanh = _activation("Tanh", "tanh")
Softmax = _activation("Softmax", "softmax")
LogSoftmax = _activation("LogSoftmax", "log_softmax")
Maxout = _activation("Maxout", "maxout")
GLU = _activation("GLU", "glu")
RReLU = _activation("RReLU", "rrelu")


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self.data_format = data_format
        self.weight = self.create_parameter(
            (num_parameters,), attr=weight_attr,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, param(self, "weight"),
                       data_format=self.data_format)
