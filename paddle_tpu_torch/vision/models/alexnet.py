"""AlexNet (``paddle_tpu.vision.models.alexnet`` counterpart): the JAX
model's layers, names and state dict.  ``device=`` as for ``ResNet``."""
from __future__ import annotations

from torch import nn as tnn

from ... import nn
from ...device import resolve_device
from ._common import no_pretrained

__all__ = ["AlexNet", "alexnet"]


class AlexNet(tnn.Module):
    def __init__(self, num_classes=1000, dropout=0.5, device=None):
        super().__init__()
        dev = resolve_device(device)
        with dev:
            self.num_classes = num_classes
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 11, stride=4, padding=2), nn.ReLU(),
                nn.MaxPool2D(3, 2),
                nn.Conv2D(64, 192, 5, padding=2), nn.ReLU(),
                nn.MaxPool2D(3, 2),
                nn.Conv2D(192, 384, 3, padding=1), nn.ReLU(),
                nn.Conv2D(384, 256, 3, padding=1), nn.ReLU(),
                nn.Conv2D(256, 256, 3, padding=1), nn.ReLU(),
                nn.MaxPool2D(3, 2))
            self.avgpool = nn.AdaptiveAvgPool2D((6, 6))
            if num_classes > 0:
                self.classifier = nn.Sequential(
                    nn.Dropout(dropout), nn.Linear(256 * 6 * 6, 4096),
                    nn.ReLU(), nn.Dropout(dropout), nn.Linear(4096, 4096),
                    nn.ReLU(), nn.Linear(4096, num_classes))
        self.to(dev)

    def forward(self, x):
        x = self.features(x)
        x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.classifier(x)
        return x


def alexnet(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return AlexNet(**kwargs)
