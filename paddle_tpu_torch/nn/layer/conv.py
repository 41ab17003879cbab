"""``Conv2D`` (``paddle_tpu.nn.layer.conv.Conv2D``): weight ``[out_c,
in_c / groups, kh, kw]`` and a bias ``[out_c]`` unless ``bias_attr=False``
(then ``bias`` is None and not in the state dict), initialised as paddle
and torch do (Kaiming-uniform with a = sqrt(5), bias uniform in
+-1/sqrt(fan_in)); the forward through ``F.conv2d``."""
from __future__ import annotations

import math

import torch
from torch import nn

from .. import functional as F
from .common import _check_attrs

__all__ = ["Conv2D"]


class Conv2D(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(f"Conv2D padding_mode={padding_mode!r}"
                                      f" is not ported (zeros only)")
        _check_attrs(weight_attr, bias_attr)
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = ((kernel_size,) * 2 if isinstance(kernel_size, int)
                             else tuple(kernel_size))
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        fan_in = in_channels // groups * math.prod(self._kernel_size)
        self.weight = nn.Parameter(torch.empty(
            (out_channels, in_channels // groups) + self._kernel_size))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        if bias_attr is False:
            self.register_parameter("bias", None)
        else:
            bound = 1.0 / math.sqrt(fan_in)
            self.bias = nn.Parameter(
                torch.empty(out_channels).uniform_(-bound, bound))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={list(self._kernel_size)}, stride={self._stride}")
