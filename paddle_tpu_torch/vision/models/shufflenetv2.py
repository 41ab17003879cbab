"""ShuffleNetV2 (``paddle_tpu.vision.models.shufflenetv2`` counterpart):
the channel shuffle, scales ``x0_25`` to ``x2_0`` and the swish variant;
the JAX model's layers, names and state dict.  ``device=`` as for
``ResNet``."""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device
from ._common import no_pretrained

__all__ = ["channel_shuffle", "InvertedResidual", "ShuffleNetV2",
           "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "shufflenet_v2_swish"]


def channel_shuffle(x, groups):
    b, c, h, w = x.shape
    x = x.reshape(b, groups, c // groups, h, w)
    x = x.permute(0, 2, 1, 3, 4)
    return x.reshape(b, c, h, w)


class InvertedResidual(tnn.Module):
    def __init__(self, in_channels, out_channels, stride, act_layer=nn.ReLU):
        super().__init__()
        self.stride = stride
        branch_features = out_channels // 2
        if self.stride == 1 and in_channels != branch_features * 2:
            raise ValueError("in_channels must equal out_channels when "
                             "stride=1")

        if self.stride > 1:
            self.branch1 = nn.Sequential(
                nn.Conv2D(in_channels, in_channels, 3, stride=stride,
                          padding=1, groups=in_channels, bias_attr=False),
                nn.BatchNorm2D(in_channels),
                nn.Conv2D(in_channels, branch_features, 1, bias_attr=False),
                nn.BatchNorm2D(branch_features), act_layer())
        branch2_in = in_channels if stride > 1 else branch_features
        self.branch2 = nn.Sequential(
            nn.Conv2D(branch2_in, branch_features, 1, bias_attr=False),
            nn.BatchNorm2D(branch_features), act_layer(),
            nn.Conv2D(branch_features, branch_features, 3, stride=stride,
                      padding=1, groups=branch_features, bias_attr=False),
            nn.BatchNorm2D(branch_features),
            nn.Conv2D(branch_features, branch_features, 1, bias_attr=False),
            nn.BatchNorm2D(branch_features), act_layer())

    def forward(self, x):
        if self.stride == 1:
            x1, x2 = x.chunk(2, dim=1)
            out = torch.cat([x1, self.branch2(x2)], dim=1)
        else:
            out = torch.cat([self.branch1(x), self.branch2(x)], dim=1)
        return channel_shuffle(out, 2)


class ShuffleNetV2(tnn.Module):
    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.with_pool = with_pool
        stage_repeats = [4, 8, 4]
        act_layer = nn.Swish if act == "swish" else nn.ReLU
        stage_out = {0.25: [24, 24, 48, 96, 512],
                     0.33: [24, 32, 64, 128, 512],
                     0.5: [24, 48, 96, 192, 1024],
                     1.0: [24, 116, 232, 464, 1024],
                     1.5: [24, 176, 352, 704, 1024],
                     2.0: [24, 244, 488, 976, 2048]}[scale]
        with dev:
            self.conv1 = nn.Sequential(
                nn.Conv2D(3, stage_out[0], 3, stride=2, padding=1,
                          bias_attr=False),
                nn.BatchNorm2D(stage_out[0]), act_layer())
            self.max_pool = nn.MaxPool2D(3, stride=2, padding=1)

            stages = []
            in_c = stage_out[0]
            for i, repeats in enumerate(stage_repeats):
                out_c = stage_out[i + 1]
                seq = [InvertedResidual(in_c, out_c, 2, act_layer)]
                for _ in range(repeats - 1):
                    seq.append(InvertedResidual(out_c, out_c, 1, act_layer))
                stages.append(nn.Sequential(*seq))
                in_c = out_c
            self.stage2, self.stage3, self.stage4 = stages
            self.conv5 = nn.Sequential(
                nn.Conv2D(in_c, stage_out[-1], 1, bias_attr=False),
                nn.BatchNorm2D(stage_out[-1]), act_layer())
            if with_pool:
                self.pool2d_avg = nn.AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.fc = nn.Linear(stage_out[-1], num_classes)
        self.to(dev)

    def forward(self, x):
        x = self.conv1(x)
        x = self.max_pool(x)
        x = self.stage2(x)
        x = self.stage3(x)
        x = self.stage4(x)
        x = self.conv5(x)
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.fc(x)
        return x


def _shufflenet(scale, act="relu", pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return ShuffleNetV2(scale=scale, act=act, **kwargs)


def shufflenet_v2_x0_25(pretrained=False, **kwargs):
    return _shufflenet(0.25, pretrained=pretrained, **kwargs)


def shufflenet_v2_x0_33(pretrained=False, **kwargs):
    return _shufflenet(0.33, pretrained=pretrained, **kwargs)


def shufflenet_v2_x0_5(pretrained=False, **kwargs):
    return _shufflenet(0.5, pretrained=pretrained, **kwargs)


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    return _shufflenet(1.0, pretrained=pretrained, **kwargs)


def shufflenet_v2_x1_5(pretrained=False, **kwargs):
    return _shufflenet(1.5, pretrained=pretrained, **kwargs)


def shufflenet_v2_x2_0(pretrained=False, **kwargs):
    return _shufflenet(2.0, pretrained=pretrained, **kwargs)


def shufflenet_v2_swish(pretrained=False, **kwargs):
    return _shufflenet(1.0, act="swish", pretrained=pretrained, **kwargs)
