"""SqueezeNet 1.0 and 1.1 (``paddle_tpu.vision.models.squeezenet``
counterpart): the JAX model's layers, names and state dict.  ``device=``
as for ``ResNet``."""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device
from ._common import no_pretrained

__all__ = ["MakeFire", "SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class MakeFire(tnn.Module):
    def __init__(self, in_channels, squeeze_channels, expand1x1_channels,
                 expand3x3_channels):
        super().__init__()
        self._conv = nn.Conv2D(in_channels, squeeze_channels, 1)
        self._conv_path1 = nn.Conv2D(squeeze_channels, expand1x1_channels, 1)
        self._conv_path2 = nn.Conv2D(squeeze_channels, expand3x3_channels, 3,
                                     padding=1)
        self.relu = nn.ReLU()

    def forward(self, x):
        x = self.relu(self._conv(x))
        x1 = self.relu(self._conv_path1(x))
        x2 = self.relu(self._conv_path2(x))
        return torch.cat([x1, x2], dim=1)


class SqueezeNet(tnn.Module):
    def __init__(self, version="1.0", num_classes=1000, with_pool=True,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.version = version
        self.num_classes = num_classes
        self.with_pool = with_pool
        with dev:
            if version == "1.0":
                self._conv = nn.Conv2D(3, 96, 7, stride=2)
                self._fires = nn.Sequential(
                    MakeFire(96, 16, 64, 64), MakeFire(128, 16, 64, 64),
                    MakeFire(128, 32, 128, 128))
                self._fires2 = nn.Sequential(
                    MakeFire(256, 32, 128, 128), MakeFire(256, 48, 192, 192),
                    MakeFire(384, 48, 192, 192), MakeFire(384, 64, 256, 256))
                self._fires3 = MakeFire(512, 64, 256, 256)
            elif version == "1.1":
                self._conv = nn.Conv2D(3, 64, 3, stride=2, padding=1)
                self._fires = nn.Sequential(
                    MakeFire(64, 16, 64, 64), MakeFire(128, 16, 64, 64))
                self._fires2 = nn.Sequential(
                    MakeFire(128, 32, 128, 128), MakeFire(256, 32, 128, 128))
                self._fires3 = nn.Sequential(
                    MakeFire(256, 48, 192, 192), MakeFire(384, 48, 192, 192),
                    MakeFire(384, 64, 256, 256), MakeFire(512, 64, 256, 256))
            else:
                raise ValueError("version must be '1.0' or '1.1'")
            self.relu = nn.ReLU()
            self.pool = nn.MaxPool2D(3, 2)
            self.dropout = nn.Dropout(0.5)
            self.final_conv = nn.Conv2D(512, num_classes if num_classes > 0
                                        else 1000, 1)
            self.avgpool = nn.AdaptiveAvgPool2D(1)
        self.to(dev)

    def forward(self, x):
        x = self.relu(self._conv(x))
        x = self.pool(x)
        x = self._fires(x)
        x = self.pool(x)
        x = self._fires2(x)
        x = self.pool(x)
        x = self._fires3(x)
        x = self.dropout(x)
        x = self.relu(self.final_conv(x))
        x = self.avgpool(x)
        return x.flatten(1)


def squeezenet1_0(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return SqueezeNet("1.1", **kwargs)
