"""Activation functionals (``paddle_tpu.nn.functional.activation``
counterparts): every single-tensor activation of the JAX package, with its
defaults (``hardsigmoid``'s slope is 0.1666667, not torch's 1/6; ``gelu``
is exact unless ``approximate=True``, the tanh form).  ``ACTIVATIONS``
names them: the values ``GPTConfig.activation`` and
``BertConfig.activation`` take."""
from __future__ import annotations

import torch
import torch.nn.functional as tF

__all__ = ["relu", "relu6", "elu", "selu", "celu", "gelu", "sigmoid",
           "log_sigmoid", "hardsigmoid", "hardswish", "hardtanh",
           "hardshrink", "softshrink", "tanhshrink", "leaky_relu",
           "softplus", "softsign", "silu", "swish", "mish", "tanh",
           "ACTIVATIONS"]


def relu(x, name=None):
    return torch.relu(x)


def relu6(x, name=None):
    return x.clamp(0.0, 6.0)


def elu(x, alpha=1.0, name=None):
    return torch.where(x > 0, x, alpha * torch.expm1(x.clamp(max=0.0)))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    return x.clamp(min=0.0) + alpha * torch.expm1(x.clamp(max=0.0) / alpha)


def gelu(x, approximate=False, name=None):
    return tF.gelu(x, approximate="tanh" if approximate else "none")


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def log_sigmoid(x, name=None):
    return tF.logsigmoid(x)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return (slope * x + offset).clamp(0.0, 1.0)


def hardswish(x, name=None):
    return x * (x + 3.0).clamp(0.0, 6.0) / 6.0


def hardtanh(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    return x.clamp(min, max)


def hardshrink(x, threshold=0.5, name=None):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5, name=None):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def leaky_relu(x, negative_slope=0.01, name=None):
    return torch.where(x >= 0, x, negative_slope * x)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return torch.where(x * beta > threshold, x,
                       torch.log1p(torch.exp(beta * x)) / beta)


def softsign(x, name=None):
    return x / (1.0 + x.abs())


def silu(x, name=None):
    return tF.silu(x)


def swish(x, name=None):
    return tF.silu(x)


def mish(x, name=None):
    return x * torch.tanh(tF.softplus(x))


def tanh(x, name=None):
    return torch.tanh(x)


ACTIVATIONS = frozenset(__all__) - {"ACTIVATIONS"}
