"""Activation layers (``paddle_tpu.nn.layer.activation`` counterparts):
``ReLU``, ``GELU``, ``Sigmoid``, ``LeakyReLU`` and ``Swish``.

Each calls its ``F`` functional.  As in the JAX package, positional
arguments map onto the functional's keyword order after ``x``
(``LeakyReLU(0.2)`` is ``negative_slope=0.2``, ``GELU(True)`` is
``approximate=True``) and ``name`` is dropped."""
from __future__ import annotations

import inspect

from torch import nn

from .. import functional as F

__all__ = ["ReLU", "GELU", "Sigmoid", "LeakyReLU", "Swish"]


class _Activation(nn.Module):
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


class ReLU(_Activation):
    _fn = "relu"


class GELU(_Activation):
    _fn = "gelu"


class Sigmoid(_Activation):
    _fn = "sigmoid"


class LeakyReLU(_Activation):
    _fn = "leaky_relu"


class Swish(_Activation):
    _fn = "swish"
