"""Weight initializers (``paddle_tpu.nn.initializer`` counterparts).

An initializer is a callable ``(shape, dtype, device) -> torch.Tensor``.
The random ones draw in f32 from the port's generator for ``device``
(``core.random.generator``, seeded by ``paddle.seed``; torch's global
generator is never touched) on that device, then cast to ``dtype``.  The
draws are not the JAX package's (its keys are functional); the
distributions, fans, bounds and exact values of the deterministic ones
are.

Fans follow ``_fan_in_out`` as the JAX package has it: a 2-D shape is
paddle's ``[in, out]`` Linear weight; a conv weight ``[out, in, *k]``
has fan-in ``in * prod(k)`` and fan-out ``out * prod(k)``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import random as rnd

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
           "Assign", "Orthogonal", "Dirac", "constant", "normal", "uniform"]


def _fan_in_out(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        # Linear weights are [in, out] in paddle
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def _device(device):
    dev = torch.device("cpu") if device is None else torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _normal(shape, device):
    dev = _device(device)
    return torch.empty(shape, device=dev).normal_(
        generator=rnd.generator(dev))


def _uniform(shape, low, high, device):
    dev = _device(device)
    return torch.empty(shape, device=dev).uniform_(
        low, high, generator=rnd.generator(dev))


def _relu_gain(negative_slope, nonlinearity):
    return math.sqrt(2.0 / (1 + negative_slope ** 2)) \
        if nonlinearity in ("relu", "leaky_relu") else 1.0


class Initializer:
    def __call__(self, shape, dtype=torch.float32, device=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype=torch.float32, device=None):
        return torch.full(tuple(shape), self.value, dtype=dtype,
                          device=_device(device))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=torch.float32, device=None):
        return (self.mean + self.std * _normal(shape, device)).to(dtype)


class TruncatedNormal(Initializer):
    """``mean + std * t``, t standard normal truncated to [-2, 2] (drawn by
    the inverse CDF of a uniform over the kept mass)."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=torch.float32, device=None):
        lo = 0.5 * (1 + math.erf(-2.0 / math.sqrt(2.0)))
        u = _uniform(shape, 2 * lo - 1, 1 - 2 * lo, device)
        t = (torch.erfinv(u) * math.sqrt(2.0)).clamp_(-2.0, 2.0)
        return (self.mean + self.std * t).to(dtype)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype=torch.float32, device=None):
        return _uniform(shape, self.low, self.high, device).to(dtype)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=torch.float32, device=None):
        fin, fout = _fan_in_out(shape)
        std = self.gain * math.sqrt(2.0 / ((self.fan_in or fin)
                                           + (self.fan_out or fout)))
        return (std * _normal(shape, device)).to(dtype)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=torch.float32, device=None):
        fin, fout = _fan_in_out(shape)
        limit = self.gain * math.sqrt(6.0 / ((self.fan_in or fin)
                                             + (self.fan_out or fout)))
        return _uniform(shape, -limit, limit, device).to(dtype)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype=torch.float32, device=None):
        fin = self.fan_in or _fan_in_out(shape)[0]
        std = _relu_gain(self.negative_slope, self.nonlinearity) \
            / math.sqrt(fin)
        return (std * _normal(shape, device)).to(dtype)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype=torch.float32, device=None):
        fin = self.fan_in or _fan_in_out(shape)[0]
        limit = _relu_gain(self.negative_slope, self.nonlinearity) \
            * math.sqrt(3.0 / fin)
        return _uniform(shape, -limit, limit, device).to(dtype)


class Assign(Initializer):
    """The given values (a numpy array, a list, a torch tensor or a
    surface Tensor), reshaped to ``shape``."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype=torch.float32, device=None):
        from ..core.tensor import Tensor
        v = self.value
        if isinstance(v, Tensor):
            v = v._value
        t = v.detach() if isinstance(v, torch.Tensor) else \
            torch.from_numpy(np.array(v))
        return t.to(_device(device), dtype).reshape(tuple(shape)).clone()


class Orthogonal(Initializer):
    """``jax.nn.initializers.orthogonal`` times ``gain``: the Q of a
    normal matrix's QR (signs fixed by R's diagonal) over the flattened
    ``[prod(shape[:-1]), shape[-1]]``, transposed when it has more
    columns than rows."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype=torch.float32, device=None):
        shape = tuple(shape)
        n_cols = shape[-1]
        n_rows = int(np.prod(shape)) // n_cols
        mat = (n_cols, n_rows) if n_rows < n_cols else (n_rows, n_cols)
        q, r = torch.linalg.qr(_normal(mat, device))
        q = q * torch.sign(torch.diagonal(r))
        if n_rows < n_cols:
            q = q.T
        return (self.gain * q.reshape(shape)).to(dtype)


class Dirac(Initializer):
    """Identity-preserving conv weights: ``w[i, i % in, centre] = 1`` for
    ``i < min(out, in * groups)``, zeros elsewhere."""

    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype=torch.float32, device=None):
        out = np.zeros(shape, dtype=np.float32)
        oc, ic = shape[0], shape[1]
        centre = tuple(s // 2 for s in shape[2:])
        for i in range(min(oc, ic * self.groups)):
            out[(i, i % ic) + centre] = 1.0
        return torch.from_numpy(out).to(_device(device), dtype)


# paddle.nn.initializer re-export names
constant = Constant
normal = Normal
uniform = Uniform
