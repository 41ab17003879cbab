"""LeNet (``paddle_tpu.vision.models.lenet`` counterpart): the JAX model's
layers, names and state dict.  ``device=`` as for ``ResNet``."""
from __future__ import annotations

from torch import nn as tnn

from ... import nn
from ...device import resolve_device

__all__ = ["LeNet"]


class LeNet(tnn.Module):
    def __init__(self, num_classes=10, device=None):
        super().__init__()
        dev = resolve_device(device)
        with dev:
            self.num_classes = num_classes
            self.features = nn.Sequential(
                nn.Conv2D(1, 6, 3, stride=1, padding=1),
                nn.ReLU(),
                nn.MaxPool2D(2, 2),
                nn.Conv2D(6, 16, 5, stride=1, padding=0),
                nn.ReLU(),
                nn.MaxPool2D(2, 2))
            if num_classes > 0:
                self.fc = nn.Sequential(
                    nn.Linear(400, 120), nn.Linear(120, 84),
                    nn.Linear(84, num_classes))
        self.to(dev)

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.fc(x)
        return x
