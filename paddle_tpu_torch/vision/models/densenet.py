"""DenseNet 121 to 264 (``paddle_tpu.vision.models.densenet``
counterpart): pre-activation (BN, ReLU, conv) dense blocks, the JAX
model's layers, names and state dict.  ``device=`` as for ``ResNet``."""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device
from ._common import no_pretrained

__all__ = ["BNACConvLayer", "DenseLayer", "DenseBlock", "TransitionLayer",
           "DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264"]


class BNACConvLayer(tnn.Module):
    """BN -> ReLU -> Conv."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 pad=0, groups=1):
        super().__init__()
        self._batch_norm = nn.BatchNorm2D(num_channels)
        self.relu = nn.ReLU()
        self._conv = nn.Conv2D(num_channels, num_filters, filter_size,
                               stride=stride, padding=pad, groups=groups,
                               bias_attr=False)

    def forward(self, x):
        return self._conv(self.relu(self._batch_norm(x)))


class DenseLayer(tnn.Module):
    def __init__(self, num_channels, growth_rate, bn_size, dropout):
        super().__init__()
        self.dropout = dropout
        self.bn_ac_func1 = BNACConvLayer(num_channels, bn_size * growth_rate,
                                         1)
        self.bn_ac_func2 = BNACConvLayer(bn_size * growth_rate, growth_rate,
                                         3, pad=1)
        if dropout:
            self.dropout_func = nn.Dropout(dropout)

    def forward(self, x):
        conv = self.bn_ac_func1(x)
        conv = self.bn_ac_func2(conv)
        if self.dropout:
            conv = self.dropout_func(conv)
        return torch.cat([x, conv], dim=1)


class DenseBlock(tnn.Module):
    def __init__(self, num_channels, num_layers, bn_size, growth_rate,
                 dropout):
        super().__init__()
        self.dense_layers = nn.LayerList([
            DenseLayer(num_channels + i * growth_rate, growth_rate, bn_size,
                       dropout) for i in range(num_layers)])

    def forward(self, x):
        for layer in self.dense_layers:
            x = layer(x)
        return x


class TransitionLayer(tnn.Module):
    def __init__(self, num_channels, num_output_features):
        super().__init__()
        self.conv_ac_func = BNACConvLayer(num_channels, num_output_features,
                                          1)
        self.pool2d_avg = nn.AvgPool2D(kernel_size=2, stride=2)

    def forward(self, x):
        return self.pool2d_avg(self.conv_ac_func(x))


class DenseNet(tnn.Module):
    _cfg = {121: (64, 32, [6, 12, 24, 16]),
            161: (96, 48, [6, 12, 36, 24]),
            169: (64, 32, [6, 12, 32, 32]),
            201: (64, 32, [6, 12, 48, 32]),
            264: (64, 32, [6, 12, 64, 48])}

    def __init__(self, layers=121, bn_size=4, dropout=0.0, num_classes=1000,
                 with_pool=True, device=None):
        super().__init__()
        dev = resolve_device(device)
        num_init_features, growth_rate, block_config = self._cfg[layers]
        self.num_classes = num_classes
        self.with_pool = with_pool
        with dev:
            self.conv1 = nn.Conv2D(3, num_init_features, 7, stride=2,
                                   padding=3, bias_attr=False)
            self.bn1 = nn.BatchNorm2D(num_init_features)
            self.relu = nn.ReLU()
            self.pool1 = nn.MaxPool2D(3, stride=2, padding=1)

            blocks, transitions = [], []
            num_features = num_init_features
            for i, num_layers in enumerate(block_config):
                blocks.append(DenseBlock(num_features, num_layers, bn_size,
                                         growth_rate, dropout))
                num_features += num_layers * growth_rate
                if i != len(block_config) - 1:
                    transitions.append(TransitionLayer(num_features,
                                                       num_features // 2))
                    num_features //= 2
            self.blocks = nn.LayerList(blocks)
            self.transitions = nn.LayerList(transitions)
            self.batch_norm = nn.BatchNorm2D(num_features)
            if with_pool:
                self.pool2d_avg = nn.AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.classifier = nn.Linear(num_features, num_classes)
        self.to(dev)

    def forward(self, x):
        x = self.pool1(self.relu(self.bn1(self.conv1(x))))
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i != len(self.blocks) - 1:
                x = self.transitions[i](x)
        x = self.relu(self.batch_norm(x))
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.classifier(x)
        return x


def _densenet(layers, pretrained, **kwargs):
    no_pretrained(pretrained)
    return DenseNet(layers=layers, **kwargs)


def densenet121(pretrained=False, **kwargs):
    return _densenet(121, pretrained, **kwargs)


def densenet161(pretrained=False, **kwargs):
    return _densenet(161, pretrained, **kwargs)


def densenet169(pretrained=False, **kwargs):
    return _densenet(169, pretrained, **kwargs)


def densenet201(pretrained=False, **kwargs):
    return _densenet(201, pretrained, **kwargs)


def densenet264(pretrained=False, **kwargs):
    return _densenet(264, pretrained, **kwargs)
