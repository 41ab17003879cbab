"""Pooling layers (``paddle_tpu.nn.layer.pooling`` counterparts):
``MaxPool2D`` and ``AdaptiveAvgPool2D`` over ``F.max_pool2d`` and
``F.adaptive_avg_pool2d``."""
from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = ["MaxPool2D", "AdaptiveAvgPool2D"]


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__()
        self._kw = dict(kernel_size=kernel_size, stride=stride,
                        padding=padding, return_mask=return_mask,
                        ceil_mode=ceil_mode, data_format=data_format)

    def forward(self, x):
        return F.max_pool2d(x, **self._kw)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self._kw = dict(output_size=output_size, data_format=data_format)

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, **self._kw)
