"""MobileNetV3 small and large (``paddle_tpu.vision.models.mobilenetv3``
counterpart): hardswish, hardsigmoid and squeeze-excite blocks, the JAX
model's layers, names and state dict.  ``device=`` as for ``ResNet``."""
from __future__ import annotations

from torch import nn as tnn

from ... import nn
from ...device import resolve_device
from ._common import no_pretrained
from .mobilenetv2 import _make_divisible

__all__ = ["SqueezeExcitation", "InvertedResidualConfig",
           "InvertedResidual", "MobileNetV3", "MobileNetV3Small",
           "MobileNetV3Large", "mobilenet_v3_small", "mobilenet_v3_large"]


class SqueezeExcitation(tnn.Module):
    def __init__(self, input_channels, squeeze_channels):
        super().__init__()
        self.avgpool = nn.AdaptiveAvgPool2D(1)
        self.fc1 = nn.Conv2D(input_channels, squeeze_channels, 1)
        self.relu = nn.ReLU()
        self.fc2 = nn.Conv2D(squeeze_channels, input_channels, 1)
        self.hardsigmoid = nn.Hardsigmoid()

    def forward(self, x):
        scale = self.avgpool(x)
        scale = self.relu(self.fc1(scale))
        scale = self.hardsigmoid(self.fc2(scale))
        return x * scale


class InvertedResidualConfig:
    def __init__(self, in_channels, kernel, expanded_channels, out_channels,
                 use_se, activation, stride, scale=1.0):
        self.in_channels = self.adjust_channels(in_channels, scale)
        self.kernel = kernel
        self.expanded_channels = self.adjust_channels(expanded_channels, scale)
        self.out_channels = self.adjust_channels(out_channels, scale)
        self.use_se = use_se
        self.use_hs = activation == "HS"
        self.stride = stride

    @staticmethod
    def adjust_channels(channels, scale):
        return _make_divisible(channels * scale)


class InvertedResidual(tnn.Module):
    def __init__(self, cfg: InvertedResidualConfig,
                 norm_layer=nn.BatchNorm2D):
        super().__init__()
        self.use_res_connect = (cfg.stride == 1 and
                                cfg.in_channels == cfg.out_channels)
        layers = []
        act = nn.Hardswish if cfg.use_hs else nn.ReLU
        if cfg.expanded_channels != cfg.in_channels:
            layers += [nn.Conv2D(cfg.in_channels, cfg.expanded_channels, 1,
                                 bias_attr=False),
                       norm_layer(cfg.expanded_channels), act()]
        layers += [nn.Conv2D(cfg.expanded_channels, cfg.expanded_channels,
                             cfg.kernel, stride=cfg.stride,
                             padding=(cfg.kernel - 1) // 2,
                             groups=cfg.expanded_channels, bias_attr=False),
                   norm_layer(cfg.expanded_channels), act()]
        if cfg.use_se:
            layers.append(SqueezeExcitation(
                cfg.expanded_channels,
                _make_divisible(cfg.expanded_channels // 4)))
        layers += [nn.Conv2D(cfg.expanded_channels, cfg.out_channels, 1,
                             bias_attr=False),
                   norm_layer(cfg.out_channels)]
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        if self.use_res_connect:
            out = x + out
        return out


class MobileNetV3(tnn.Module):
    def __init__(self, config, last_channel, scale=1.0, num_classes=1000,
                 with_pool=True, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.with_pool = with_pool
        with dev:
            firstconv_out = config[0].in_channels
            layers = [nn.Conv2D(3, firstconv_out, 3, stride=2, padding=1,
                                bias_attr=False),
                      nn.BatchNorm2D(firstconv_out), nn.Hardswish()]
            layers += [InvertedResidual(cfg) for cfg in config]
            lastconv_in = config[-1].out_channels
            lastconv_out = 6 * lastconv_in
            layers += [nn.Conv2D(lastconv_in, lastconv_out, 1,
                                 bias_attr=False),
                       nn.BatchNorm2D(lastconv_out), nn.Hardswish()]
            self.features = nn.Sequential(*layers)
            if with_pool:
                self.avgpool = nn.AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.classifier = nn.Sequential(
                    nn.Linear(lastconv_out, last_channel), nn.Hardswish(),
                    nn.Dropout(0.2), nn.Linear(last_channel, num_classes))
        self.to(dev)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.classifier(x)
        return x


class MobileNetV3Small(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None):
        config = [
            InvertedResidualConfig(16, 3, 16, 16, True, "RE", 2, scale),
            InvertedResidualConfig(16, 3, 72, 24, False, "RE", 2, scale),
            InvertedResidualConfig(24, 3, 88, 24, False, "RE", 1, scale),
            InvertedResidualConfig(24, 5, 96, 40, True, "HS", 2, scale),
            InvertedResidualConfig(40, 5, 240, 40, True, "HS", 1, scale),
            InvertedResidualConfig(40, 5, 240, 40, True, "HS", 1, scale),
            InvertedResidualConfig(40, 5, 120, 48, True, "HS", 1, scale),
            InvertedResidualConfig(48, 5, 144, 48, True, "HS", 1, scale),
            InvertedResidualConfig(48, 5, 288, 96, True, "HS", 2, scale),
            InvertedResidualConfig(96, 5, 576, 96, True, "HS", 1, scale),
            InvertedResidualConfig(96, 5, 576, 96, True, "HS", 1, scale)]
        last_channel = _make_divisible(1024 * scale)
        super().__init__(config, last_channel, scale, num_classes, with_pool,
                         device)


class MobileNetV3Large(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None):
        config = [
            InvertedResidualConfig(16, 3, 16, 16, False, "RE", 1, scale),
            InvertedResidualConfig(16, 3, 64, 24, False, "RE", 2, scale),
            InvertedResidualConfig(24, 3, 72, 24, False, "RE", 1, scale),
            InvertedResidualConfig(24, 5, 72, 40, True, "RE", 2, scale),
            InvertedResidualConfig(40, 5, 120, 40, True, "RE", 1, scale),
            InvertedResidualConfig(40, 5, 120, 40, True, "RE", 1, scale),
            InvertedResidualConfig(40, 3, 240, 80, False, "HS", 2, scale),
            InvertedResidualConfig(80, 3, 200, 80, False, "HS", 1, scale),
            InvertedResidualConfig(80, 3, 184, 80, False, "HS", 1, scale),
            InvertedResidualConfig(80, 3, 184, 80, False, "HS", 1, scale),
            InvertedResidualConfig(80, 3, 480, 112, True, "HS", 1, scale),
            InvertedResidualConfig(112, 3, 672, 112, True, "HS", 1, scale),
            InvertedResidualConfig(112, 5, 672, 160, True, "HS", 2, scale),
            InvertedResidualConfig(160, 5, 960, 160, True, "HS", 1, scale),
            InvertedResidualConfig(160, 5, 960, 160, True, "HS", 1, scale)]
        last_channel = _make_divisible(1280 * scale)
        super().__init__(config, last_channel, scale, num_classes, with_pool,
                         device)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV3Small(scale=scale, **kwargs)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV3Large(scale=scale, **kwargs)
