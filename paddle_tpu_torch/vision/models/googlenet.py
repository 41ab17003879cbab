"""GoogLeNet, Inception v1 (``paddle_tpu.vision.models.googlenet``
counterpart): with a head it returns ``(out, out1, out2)``, the main and
the two auxiliary classifiers' logits, in training and eval mode alike;
the JAX model's layers, names and state dict.  The auxiliary heads'
``Linear(1152, ...)`` fixes the input at 224^2-class sizes (3 x 3 after
their 5 x 5 / 3 pool).  ``device=`` as for ``ResNet``."""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device
from ._common import no_pretrained

__all__ = ["ConvLayer", "Inception", "GoogLeNet", "googlenet"]


class ConvLayer(tnn.Module):
    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 groups=1):
        super().__init__()
        self._conv = nn.Conv2D(num_channels, num_filters, filter_size,
                               stride=stride, padding=(filter_size - 1) // 2,
                               groups=groups, bias_attr=False)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.relu(self._conv(x))


class Inception(tnn.Module):
    def __init__(self, input_channels, output_channels, filter1, filter3R,
                 filter3, filter5R, filter5, proj):
        super().__init__()
        self._conv1 = ConvLayer(input_channels, filter1, 1)
        self._conv3r = ConvLayer(input_channels, filter3R, 1)
        self._conv3 = ConvLayer(filter3R, filter3, 3)
        self._conv5r = ConvLayer(input_channels, filter5R, 1)
        self._conv5 = ConvLayer(filter5R, filter5, 5)
        self._pool = nn.MaxPool2D(kernel_size=3, stride=1, padding=1)
        self._convprj = ConvLayer(input_channels, proj, 1)

    def forward(self, x):
        return torch.cat([self._conv1(x), self._conv3(self._conv3r(x)),
                          self._conv5(self._conv5r(x)),
                          self._convprj(self._pool(x))], dim=1)


class GoogLeNet(tnn.Module):
    def __init__(self, num_classes=1000, with_pool=True, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.with_pool = with_pool
        with dev:
            self._conv = ConvLayer(3, 64, 7, 2)
            self._pool = nn.MaxPool2D(kernel_size=3, stride=2)
            self._conv_1 = ConvLayer(64, 64, 1)
            self._conv_2 = ConvLayer(64, 192, 3)

            self._ince3a = Inception(192, 192, 64, 96, 128, 16, 32, 32)
            self._ince3b = Inception(256, 256, 128, 128, 192, 32, 96, 64)
            self._ince4a = Inception(480, 480, 192, 96, 208, 16, 48, 64)
            self._ince4b = Inception(512, 512, 160, 112, 224, 24, 64, 64)
            self._ince4c = Inception(512, 512, 128, 128, 256, 24, 64, 64)
            self._ince4d = Inception(512, 512, 112, 144, 288, 32, 64, 64)
            self._ince4e = Inception(528, 528, 256, 160, 320, 32, 128, 128)
            self._ince5a = Inception(832, 832, 256, 160, 320, 32, 128, 128)
            self._ince5b = Inception(832, 832, 384, 192, 384, 48, 128, 128)

            if with_pool:
                self._pool_5 = nn.AdaptiveAvgPool2D(1)
                self._pool_o1 = nn.AvgPool2D(kernel_size=5, stride=3)
                self._pool_o2 = nn.AvgPool2D(kernel_size=5, stride=3)
            if num_classes > 0:
                self._drop = nn.Dropout(p=0.4)
                self.out = nn.Linear(1024, num_classes)
                self._conv_o1 = ConvLayer(512, 128, 1)
                self._fc_o1 = nn.Linear(1152, 1024)
                self._drop_o1 = nn.Dropout(p=0.7)
                self.out1 = nn.Linear(1024, num_classes)
                self._conv_o2 = ConvLayer(528, 128, 1)
                self._fc_o2 = nn.Linear(1152, 1024)
                self._drop_o2 = nn.Dropout(p=0.7)
                self.out2 = nn.Linear(1024, num_classes)
            self.relu = nn.ReLU()
        self.to(dev)

    def forward(self, inputs):
        x = self._conv(inputs)
        x = self._pool(x)
        x = self._conv_1(x)
        x = self._conv_2(x)
        x = self._pool(x)
        x = self._ince3a(x)
        x = self._ince3b(x)
        x = self._pool(x)
        ince4a = self._ince4a(x)
        x = self._ince4b(ince4a)
        x = self._ince4c(x)
        ince4d = self._ince4d(x)
        x = self._ince4e(ince4d)
        x = self._pool(x)
        x = self._ince5a(x)
        ince5b = self._ince5b(x)

        outputs = [ince5b]
        if self.with_pool:
            outputs[0] = self._pool_5(ince5b)
        if self.num_classes > 0:
            out = self._drop(outputs[0]).flatten(1)
            out = self.out(out)
            o1 = self._pool_o1(ince4a)
            o1 = self._conv_o1(o1).flatten(1)
            o1 = self.relu(self._fc_o1(o1))
            o1 = self._drop_o1(o1)
            out1 = self.out1(o1)
            o2 = self._pool_o2(ince4d)
            o2 = self._conv_o2(o2).flatten(1)
            o2 = self.relu(self._fc_o2(o2))
            o2 = self._drop_o2(o2)
            out2 = self.out2(o2)
            return out, out1, out2
        return outputs[0]


def googlenet(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return GoogLeNet(**kwargs)
