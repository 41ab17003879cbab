"""Activation functionals (``paddle_tpu.nn.functional.activation``
counterparts): every single-tensor activation of the JAX package, with its
defaults (``hardsigmoid``'s slope is 0.1666667, not torch's 1/6; ``gelu``
is exact unless ``approximate=True``, the tanh form).  ``ACTIVATIONS``
names them: the values ``GPTConfig.activation`` and
``BertConfig.activation`` take."""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ...core import random as rnd
from ...core.dtype import convert_dtype
from ...core.op import defop

__all__ = ["relu", "relu6", "elu", "selu", "celu", "gelu", "sigmoid",
           "log_sigmoid", "hardsigmoid", "hardswish", "hardtanh",
           "hardshrink", "softshrink", "tanhshrink", "leaky_relu",
           "softplus", "softsign", "silu", "swish", "mish", "tanh",
           "ACTIVATIONS"]


@defop
def relu(x, name=None):
    return torch.relu(x)


@defop
def relu6(x, name=None):
    return x.clamp(0.0, 6.0)


@defop
def elu(x, alpha=1.0, name=None):
    return torch.where(x > 0, x, alpha * torch.expm1(x.clamp(max=0.0)))


@defop
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@defop
def celu(x, alpha=1.0, name=None):
    return x.clamp(min=0.0) + alpha * torch.expm1(x.clamp(max=0.0) / alpha)


@defop
def gelu(x, approximate=False, name=None):
    return tF.gelu(x, approximate="tanh" if approximate else "none")


@defop
def sigmoid(x, name=None):
    return torch.sigmoid(x)


@defop
def log_sigmoid(x, name=None):
    return tF.logsigmoid(x)


@defop
def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return (slope * x + offset).clamp(0.0, 1.0)


@defop
def hardswish(x, name=None):
    return x * (x + 3.0).clamp(0.0, 6.0) / 6.0


@defop
def hardtanh(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    return x.clamp(min, max)


@defop
def hardshrink(x, threshold=0.5, name=None):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


@defop
def softshrink(x, threshold=0.5, name=None):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


@defop
def tanhshrink(x, name=None):
    return x - torch.tanh(x)


@defop
def leaky_relu(x, negative_slope=0.01, name=None):
    return torch.where(x >= 0, x, negative_slope * x)


@defop
def softplus(x, beta=1.0, threshold=20.0, name=None):
    return torch.where(x * beta > threshold, x,
                       torch.log1p(torch.exp(beta * x)) / beta)


@defop
def softsign(x, name=None):
    return x / (1.0 + x.abs())


@defop
def silu(x, name=None):
    return tF.silu(x)


@defop
def swish(x, name=None):
    return tF.silu(x)


@defop
def mish(x, name=None):
    return x * torch.tanh(tF.softplus(x))


@defop
def tanh(x, name=None):
    return torch.tanh(x)


ACTIVATIONS = frozenset(__all__) - {"ACTIVATIONS"}

__all__ += ["relu_", "prelu", "rrelu", "softmax", "log_softmax",
            "gumbel_softmax", "maxout", "glu", "temperature_scaled_softmax"]


@defop
def relu_(x, name=None):
    return torch.relu(x)


@defop
def prelu(x, weight, data_format="NCHW", name=None):
    w = weight
    if w.dim() == 1 and w.shape[0] > 1 and x.dim() > 1:
        ch_axis = 1 if data_format[1] == "C" else x.dim() - 1
        shape = [1] * x.dim()
        shape[ch_axis] = w.shape[0]
        w = w.reshape(shape)
    return torch.where(x >= 0, x, w * x)


@defop
def rrelu(x, lower=0.125, upper=0.3333333333333333, training=False,
          name=None):
    if training:
        slope = torch.empty_like(x).uniform_(
            lower, upper, generator=rnd.generator(x.device))
    else:
        slope = (lower + upper) / 2.0
    return torch.where(x >= 0, x, slope * x)


@defop
def softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    return torch.softmax(x, dim=int(axis))


@defop
def log_softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    return torch.log_softmax(x, dim=int(axis))


@defop(register=False)
def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """Softmax of ``(x + g) / temperature``, g Gumbel noise from the
    port's generator; ``hard`` gives the one-hot of the argmax with the
    soft gradient."""
    u = torch.empty_like(x).uniform_(1e-20, 1.0,
                                     generator=rnd.generator(x.device))
    y = torch.softmax((x - torch.log(-torch.log(u))) / temperature, dim=axis)
    if hard:
        onehot = torch.zeros_like(y).scatter_(
            axis, y.argmax(dim=axis, keepdim=True), 1.0)
        y = onehot + y - y.detach()
    return y


@defop
def maxout(x, groups, axis=1, name=None):
    axis = int(axis) % x.dim()
    c = x.shape[axis]
    shape = x.shape[:axis] + (c // groups, groups) + x.shape[axis + 1:]
    return x.reshape(shape).amax(dim=axis + 1)


@defop
def glu(x, axis=-1, name=None):
    a, b = torch.chunk(x, 2, dim=int(axis))
    return a * torch.sigmoid(b)


@defop
def temperature_scaled_softmax(x, temperature=1.0, axis=-1, name=None):
    return torch.softmax(x / temperature, dim=axis)
