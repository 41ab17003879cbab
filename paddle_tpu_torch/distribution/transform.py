"""The transforms and ``TransformedDistribution`` (``paddle_tpu.
distribution.transform`` counterparts), in torch on the operands'
device; results are tape-free, as the distributions' are."""
from __future__ import annotations

import math

import torch
from torch.nn import functional as tF

from .distributions import Distribution, _t, _wrap


class Transform:
    def forward(self, x):
        return _wrap(self._forward(_t(x)))

    def inverse(self, y):
        return _wrap(self._inverse(_t(y)))

    def forward_log_det_jacobian(self, x):
        return _wrap(self._fldj(_t(x)))

    def inverse_log_det_jacobian(self, y):
        return _wrap(-self._fldj(self._inverse(_t(y))))

    def __call__(self, x):
        return self.forward(x)

    def _forward(self, x):
        raise NotImplementedError

    def _inverse(self, y):
        raise NotImplementedError

    def _fldj(self, x):
        raise NotImplementedError


class AffineTransform(Transform):
    def __init__(self, loc, scale):
        self.loc = _t(loc)
        self.scale = _t(scale)

    def _forward(self, x):
        return self.loc + self.scale * x

    def _inverse(self, y):
        return (y - self.loc) / self.scale

    def _fldj(self, x):
        return torch.log(torch.abs(self.scale)).expand(x.shape)


class ExpTransform(Transform):
    def _forward(self, x):
        return torch.exp(x)

    def _inverse(self, y):
        return torch.log(y)

    def _fldj(self, x):
        return x


class AbsTransform(Transform):
    def _forward(self, x):
        return torch.abs(x)

    def _inverse(self, y):
        return y  # principal branch

    def _fldj(self, x):
        return torch.zeros_like(x)


class PowerTransform(Transform):
    def __init__(self, power):
        self.power = _t(power)

    def _forward(self, x):
        return torch.pow(x, self.power)

    def _inverse(self, y):
        return torch.pow(y, 1.0 / self.power)

    def _fldj(self, x):
        return torch.log(torch.abs(self.power * torch.pow(x, self.power - 1)))


class SigmoidTransform(Transform):
    def _forward(self, x):
        return 1 / (1 + torch.exp(-x))

    def _inverse(self, y):
        return torch.log(y) - torch.log1p(-y)

    def _fldj(self, x):
        return -tF.softplus(-x) - tF.softplus(x)


class TanhTransform(Transform):
    def _forward(self, x):
        return torch.tanh(x)

    def _inverse(self, y):
        return torch.atanh(torch.clip(y, -1 + 1e-7, 1 - 1e-7))

    def _fldj(self, x):
        return 2.0 * (math.log(2.0) - x - tF.softplus(-2.0 * x))


class SoftmaxTransform(Transform):
    def _forward(self, x):
        e = torch.exp(x - x.amax(-1, keepdim=True))
        return e / e.sum(-1, keepdim=True)

    def _inverse(self, y):
        return torch.log(y)

    def _fldj(self, x):
        raise NotImplementedError("softmax is not a bijection")


class ChainTransform(Transform):
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def _forward(self, x):
        for t in self.transforms:
            x = t._forward(x)
        return x

    def _inverse(self, y):
        for t in reversed(self.transforms):
            y = t._inverse(y)
        return y

    def _fldj(self, x):
        total = 0.0
        for t in self.transforms:
            total = total + t._fldj(x)
            x = t._forward(x)
        return total


class TransformedDistribution(Distribution):
    """A base distribution pushed through a chain of transforms."""

    def __init__(self, base: Distribution, transforms):
        if isinstance(transforms, Transform):
            transforms = [transforms]
        self.base = base
        self.transforms = list(transforms)
        super().__init__(base.batch_shape, base.event_shape)

    def sample(self, shape=()):
        x = self.base.sample(shape)._value
        for t in self.transforms:
            x = t._forward(x)
        return _wrap(x)

    def rsample(self, shape=()):
        x = self.base.rsample(shape)._value
        for t in self.transforms:
            x = t._forward(x)
        return _wrap(x)

    def log_prob(self, value):
        y = _t(value)
        lp = 0.0
        for t in reversed(self.transforms):
            x = t._inverse(y)
            lp = lp - t._fldj(x)
            y = x
        return _wrap(lp + self.base.log_prob(_wrap(y))._value)
