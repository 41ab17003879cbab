"""InceptionV3 (``paddle_tpu.vision.models.inceptionv3`` counterpart):
the JAX model's layers, names and state dict (stem, blocks A to E).
``device=`` as for ``ResNet``."""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device
from ._common import no_pretrained

__all__ = ["ConvBNLayer", "InceptionStem", "InceptionA", "InceptionB",
           "InceptionC", "InceptionD", "InceptionE", "InceptionV3",
           "inception_v3"]


class ConvBNLayer(tnn.Module):
    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, groups=1):
        super().__init__()
        self.conv = nn.Conv2D(num_channels, num_filters, filter_size,
                              stride=stride, padding=padding, groups=groups,
                              bias_attr=False)
        self.bn = nn.BatchNorm2D(num_filters)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))


class InceptionStem(tnn.Module):
    def __init__(self):
        super().__init__()
        self.conv_1a_3x3 = ConvBNLayer(3, 32, 3, stride=2)
        self.conv_2a_3x3 = ConvBNLayer(32, 32, 3)
        self.conv_2b_3x3 = ConvBNLayer(32, 64, 3, padding=1)
        self.max_pool = nn.MaxPool2D(kernel_size=3, stride=2)
        self.conv_3b_1x1 = ConvBNLayer(64, 80, 1)
        self.conv_4a_3x3 = ConvBNLayer(80, 192, 3)

    def forward(self, x):
        x = self.conv_1a_3x3(x)
        x = self.conv_2a_3x3(x)
        x = self.conv_2b_3x3(x)
        x = self.max_pool(x)
        x = self.conv_3b_1x1(x)
        x = self.conv_4a_3x3(x)
        return self.max_pool(x)


class InceptionA(tnn.Module):
    def __init__(self, num_channels, pool_features):
        super().__init__()
        self.branch1x1 = ConvBNLayer(num_channels, 64, 1)
        self.branch5x5_1 = ConvBNLayer(num_channels, 48, 1)
        self.branch5x5_2 = ConvBNLayer(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = ConvBNLayer(num_channels, 64, 1)
        self.branch3x3dbl_2 = ConvBNLayer(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = ConvBNLayer(96, 96, 3, padding=1)
        self.branch_pool = nn.AvgPool2D(kernel_size=3, stride=1, padding=1)
        self.branch_pool_conv = ConvBNLayer(num_channels, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool_conv(self.branch_pool(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(tnn.Module):
    def __init__(self, num_channels):
        super().__init__()
        self.branch3x3 = ConvBNLayer(num_channels, 384, 3, stride=2)
        self.branch3x3dbl_1 = ConvBNLayer(num_channels, 64, 1)
        self.branch3x3dbl_2 = ConvBNLayer(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = ConvBNLayer(96, 96, 3, stride=2)
        self.branch_pool = nn.MaxPool2D(kernel_size=3, stride=2)

    def forward(self, x):
        return torch.cat([self.branch3x3(x),
                       self.branch3x3dbl_3(self.branch3x3dbl_2(
                           self.branch3x3dbl_1(x))),
                       self.branch_pool(x)], dim=1)


class InceptionC(tnn.Module):
    def __init__(self, num_channels, channels_7x7):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = ConvBNLayer(num_channels, 192, 1)
        self.branch7x7_1 = ConvBNLayer(num_channels, c7, 1)
        self.branch7x7_2 = ConvBNLayer(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = ConvBNLayer(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = ConvBNLayer(num_channels, c7, 1)
        self.branch7x7dbl_2 = ConvBNLayer(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = ConvBNLayer(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = ConvBNLayer(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = ConvBNLayer(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = nn.AvgPool2D(kernel_size=3, stride=1, padding=1)
        self.branch_pool_conv = ConvBNLayer(num_channels, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        b7d = self.branch7x7dbl_5(self.branch7x7dbl_4(self.branch7x7dbl_3(
            self.branch7x7dbl_2(self.branch7x7dbl_1(x)))))
        bp = self.branch_pool_conv(self.branch_pool(x))
        return torch.cat([b1, b7, b7d, bp], dim=1)


class InceptionD(tnn.Module):
    def __init__(self, num_channels):
        super().__init__()
        self.branch3x3_1 = ConvBNLayer(num_channels, 192, 1)
        self.branch3x3_2 = ConvBNLayer(192, 320, 3, stride=2)
        self.branch7x7x3_1 = ConvBNLayer(num_channels, 192, 1)
        self.branch7x7x3_2 = ConvBNLayer(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = ConvBNLayer(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = ConvBNLayer(192, 192, 3, stride=2)
        self.branch_pool = nn.MaxPool2D(kernel_size=3, stride=2)

    def forward(self, x):
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)),
                       self.branch7x7x3_4(self.branch7x7x3_3(
                           self.branch7x7x3_2(self.branch7x7x3_1(x)))),
                       self.branch_pool(x)], dim=1)


class InceptionE(tnn.Module):
    def __init__(self, num_channels):
        super().__init__()
        self.branch1x1 = ConvBNLayer(num_channels, 320, 1)
        self.branch3x3_1 = ConvBNLayer(num_channels, 384, 1)
        self.branch3x3_2a = ConvBNLayer(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = ConvBNLayer(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = ConvBNLayer(num_channels, 448, 1)
        self.branch3x3dbl_2 = ConvBNLayer(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = ConvBNLayer(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = ConvBNLayer(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = nn.AvgPool2D(kernel_size=3, stride=1, padding=1)
        self.branch_pool_conv = ConvBNLayer(num_channels, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        b3d = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        b3d = torch.cat([self.branch3x3dbl_3a(b3d), self.branch3x3dbl_3b(b3d)],
                     dim=1)
        bp = self.branch_pool_conv(self.branch_pool(x))
        return torch.cat([b1, b3, b3d, bp], dim=1)


class InceptionV3(tnn.Module):
    def __init__(self, num_classes=1000, with_pool=True, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.with_pool = with_pool
        with dev:
            self.inception_stem = InceptionStem()
            self.inception_block_list = nn.LayerList([
                InceptionA(192, 32), InceptionA(256, 64),
                InceptionA(288, 64), InceptionB(288),
                InceptionC(768, 128), InceptionC(768, 160),
                InceptionC(768, 160), InceptionC(768, 192),
                InceptionD(768),
                InceptionE(1280), InceptionE(2048)])
            if with_pool:
                self.avg_pool = nn.AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.dropout = nn.Dropout(p=0.2)
                self.fc = nn.Linear(2048, num_classes)
        self.to(dev)

    def forward(self, x):
        x = self.inception_stem(x)
        for block in self.inception_block_list:
            x = block(x)
        if self.with_pool:
            x = self.avg_pool(x)
        if self.num_classes > 0:
            x = self.dropout(x)
            x = x.flatten(1)
            x = self.fc(x)
        return x


def inception_v3(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return InceptionV3(**kwargs)
