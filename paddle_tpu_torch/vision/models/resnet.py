"""The ResNet family (``paddle_tpu.vision.models.resnet`` counterpart):
``BasicBlock``, ``BottleneckBlock``, ``ResNet`` and the constructors
``resnet18`` through ``wide_resnet101_2``.

The layers, their names and the state dict are the JAX model's: bias-free
convolutions, each followed by a ``BatchNorm2D`` with ``_mean`` /
``_variance`` buffers, ``downsample`` as ``Sequential(Conv2D,
BatchNorm2D)``, and a ``fc`` ``Linear`` head (``[in, out]`` in the JAX
state, transposed by ``models.convert``).  Images are NCHW; the model also
runs on ``channels_last`` tensors, which are the same NCHW tensors in
another memory order.

``stem_s2d=True`` runs the 7x7 / stride-2 stem as the reference's
space-to-depth transform: the input packed 2x2 into channels and the
kernel rearranged into an equivalent 4x4 / stride-1 kernel over 12
channels, the same parameters and the same function up to summation
order.  Odd image sizes take the plain stem.

The convolutions run through ``F.conv2d`` (``torch.nn.functional.conv2d``),
as the reference's run through ``lax.conv_general_dilated``: the Pallas
conv+BN kernels of ``tools/exp_conv*.py`` (and their port in
``kernels.conv_bn``) are experiments that neither model calls.

``ResNet`` and the constructors take ``device=`` (default ``"cuda"``;
raises without a card, see ``device.resolve_device``) and return the model
in training mode, the JAX model's default.  ``pretrained=True`` raises, as
in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF
from torch import nn as tnn

from ... import nn
from ...device import resolve_device

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
           "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d",
           "wide_resnet50_2", "wide_resnet101_2", "resnet_conv_flops"]


class BasicBlock(tnn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None):
        super().__init__()
        norm_layer = norm_layer or nn.BatchNorm2D
        if groups != 1 or base_width != 64:
            raise ValueError("BasicBlock only supports groups=1, base_width=64")
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                               bias_attr=False)
        self.bn1 = norm_layer(planes)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(tnn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None):
        super().__init__()
        norm_layer = norm_layer or nn.BatchNorm2D
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False)
        self.bn1 = norm_layer(width)
        self.conv2 = nn.Conv2D(width, width, 3, padding=dilation,
                               stride=stride, groups=groups, dilation=dilation,
                               bias_attr=False)
        self.bn2 = norm_layer(width)
        self.conv3 = nn.Conv2D(width, planes * self.expansion, 1,
                               bias_attr=False)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = nn.ReLU()
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(tnn.Module):
    """``depth`` selects the block layout; ``with_pool`` and
    ``num_classes`` control the head, as in the reference."""

    _spec = {18: (BasicBlock, [2, 2, 2, 2]),
             34: (BasicBlock, [3, 4, 6, 3]),
             50: (BottleneckBlock, [3, 4, 6, 3]),
             101: (BottleneckBlock, [3, 4, 23, 3]),
             152: (BottleneckBlock, [3, 8, 36, 3])}

    def __init__(self, block=None, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, stem_s2d=False, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.stem_s2d = bool(stem_s2d)
        if block is None:
            block, layers = self._spec[depth]
        else:
            layers = self._spec[depth][1]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.inplanes = 64
        self.dilation = 1

        self.conv1 = nn.Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                               bias_attr=False)
        self.bn1 = nn.BatchNorm2D(self.inplanes)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(kernel_size=3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes)
        self.to(dev)

    def _make_layer(self, block, planes, blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False),
                nn.BatchNorm2D(planes * block.expansion))
        layers = [block(self.inplanes, planes, stride, downsample, self.groups,
                        self.base_width)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width))
        return nn.Sequential(*layers)

    def _stem_s2d(self, x):
        """conv1 as a 4x4 / stride-1 conv on the 2x2-packed input (the
        kernel padded one row and column at the front so the stride-2
        taps line up with the packing)."""
        w = self.conv1.weight      # [64, 3, 7, 7]
        b, c, h, wd = x.shape
        xp = x.reshape(b, c, h // 2, 2, wd // 2, 2).permute(
            0, 1, 3, 5, 2, 4).reshape(b, c * 4, h // 2, wd // 2)
        k8 = tF.pad(w, (1, 0, 1, 0))
        o, ci = w.shape[:2]
        # K'[o, (c, r, s), a, b] = K8[o, c, 2a + r, 2b + s]
        kp = k8.reshape(o, ci, 4, 2, 4, 2).permute(0, 1, 3, 5, 2, 4).reshape(
            o, ci * 4, 4, 4)
        return tF.conv2d(tF.pad(xp, (2, 1, 2, 1)), kp)

    def forward(self, x):
        if self.stem_s2d and x.shape[-1] % 2 == 0 and x.shape[-2] % 2 == 0:
            x = self.relu(self.bn1(self._stem_s2d(x)))
        else:
            x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.fc(x)
        return x


def resnet_conv_flops(model, height=224, width=224) -> float:
    """Forward flops of one image through ``model``'s convolutions and
    ``fc``, at 2 a multiply-add, from the shapes one forward of a zero
    image gives (run in eval mode without gradients, so nothing updates;
    the model's mode is restored).  Batch norm, activations and pooling
    are not counted."""
    if model.stem_s2d and height % 2 == 0 and width % 2 == 0:
        raise ValueError("resnet_conv_flops counts the plain stem: build the "
                         "model with stem_s2d=False")
    total = [0.0]

    def conv_hook(mod, inp, out):
        k = mod.weight.shape[1] * mod.weight.shape[2] * mod.weight.shape[3]
        total[0] += 2.0 * out[0].numel() * k

    def fc_hook(mod, inp, out):
        total[0] += 2.0 * mod.in_features * mod.out_features

    hooks = [m.register_forward_hook(conv_hook if isinstance(m, nn.Conv2D)
                                     else fc_hook)
             for m in model.modules() if isinstance(m, (nn.Conv2D, nn.Linear))]
    was_training = model.training
    p = next(model.parameters())
    try:
        model.eval()
        with torch.no_grad():
            model(torch.zeros(1, 3, height, width, dtype=p.dtype,
                              device=p.device))
    finally:
        model.train(was_training)
        for h in hooks:
            h.remove()
    return total[0]


def _resnet(arch, Block, depth, pretrained, **kwargs):
    if pretrained:
        raise ValueError(
            "pretrained weights are not bundled in this build; load a local "
            "state dict with models.load_jax_state instead")
    return ResNet(Block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet("resnet18", BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet("resnet34", BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet("resnet50", BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet("resnet101", BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet("resnet152", BottleneckBlock, 152, pretrained, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnet("resnext50_32x4d", BottleneckBlock, 50, pretrained,
                   groups=32, width=4, **kwargs)


def resnext50_64x4d(pretrained=False, **kwargs):
    return _resnet("resnext50_64x4d", BottleneckBlock, 50, pretrained,
                   groups=64, width=4, **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    return _resnet("resnext101_32x4d", BottleneckBlock, 101, pretrained,
                   groups=32, width=4, **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    return _resnet("resnext101_64x4d", BottleneckBlock, 101, pretrained,
                   groups=64, width=4, **kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    return _resnet("resnext152_32x4d", BottleneckBlock, 152, pretrained,
                   groups=32, width=4, **kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    return _resnet("resnext152_64x4d", BottleneckBlock, 152, pretrained,
                   groups=64, width=4, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return _resnet("wide_resnet50_2", BottleneckBlock, 50, pretrained,
                   width=128, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    return _resnet("wide_resnet101_2", BottleneckBlock, 101, pretrained,
                   width=128, **kwargs)
