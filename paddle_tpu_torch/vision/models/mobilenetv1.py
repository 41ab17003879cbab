"""MobileNetV1 (``paddle_tpu.vision.models.mobilenetv1`` counterpart): the
JAX model's layers, names and state dict.  ``device=`` as for
``ResNet``."""
from __future__ import annotations

from torch import nn as tnn

from ... import nn
from ...device import resolve_device
from ._common import no_pretrained

__all__ = ["ConvBNLayer", "DepthwiseSeparable", "MobileNetV1",
           "mobilenet_v1"]


class ConvBNLayer(tnn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, num_groups=1):
        super().__init__()
        self._conv = nn.Conv2D(in_channels, out_channels, kernel_size,
                               stride=stride, padding=padding,
                               groups=num_groups, bias_attr=False)
        self._norm_layer = nn.BatchNorm2D(out_channels)
        self._act = nn.ReLU()

    def forward(self, x):
        return self._act(self._norm_layer(self._conv(x)))


class DepthwiseSeparable(tnn.Module):
    def __init__(self, in_channels, out_channels1, out_channels2, num_groups,
                 stride, scale):
        super().__init__()
        self._depthwise_conv = ConvBNLayer(
            in_channels, int(out_channels1 * scale), 3, stride=stride,
            padding=1, num_groups=int(num_groups * scale))
        self._pointwise_conv = ConvBNLayer(
            int(out_channels1 * scale), int(out_channels2 * scale), 1)

    def forward(self, x):
        return self._pointwise_conv(self._depthwise_conv(x))


class MobileNetV1(tnn.Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        with dev:
            self.conv1 = ConvBNLayer(3, int(32 * scale), 3, stride=2,
                                     padding=1)
            cfg = [  # in, out1, out2, groups, stride
                (32, 32, 64, 32, 1), (64, 64, 128, 64, 2),
                (128, 128, 128, 128, 1), (128, 128, 256, 128, 2),
                (256, 256, 256, 256, 1), (256, 256, 512, 256, 2),
                (512, 512, 512, 512, 1), (512, 512, 512, 512, 1),
                (512, 512, 512, 512, 1), (512, 512, 512, 512, 1),
                (512, 512, 512, 512, 1), (512, 512, 1024, 512, 2),
                (1024, 1024, 1024, 1024, 1),
            ]
            blocks = [DepthwiseSeparable(int(i * scale), o1, o2, g, s, scale)
                      for i, o1, o2, g, s in cfg]
            self.dwsl = nn.Sequential(*blocks)
            if with_pool:
                self.pool2d_avg = nn.AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.fc = nn.Linear(int(1024 * scale), num_classes)
        self.to(dev)

    def forward(self, x):
        x = self.conv1(x)
        x = self.dwsl(x)
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.fc(x)
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV1(scale=scale, **kwargs)
